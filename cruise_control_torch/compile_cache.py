"""Persistent kernel-build cache.

The JAX package's compile_cache.py points XLA's compilation cache at a
durable directory so a restarted service does not compile its programs
again. The port's device code is its hand-written CUDA kernels, each built
by nvcc into a shared library named by the hash of its source
(kernels/build.py); this module points that build directory at a durable
one, so a restarted service loads the libraries instead of building them
(about 15 s of nvcc for the fourteen kernels).

Call `enable_persistent_cache()` before the first kernel is built. Safe to
call more than once: the first directory stays in force.
"""

from __future__ import annotations

import os
from typing import Optional

from cruise_control_torch.kernels import build

_DEFAULT_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "build",
                            "cruise_control_torch")

_enabled: Optional[str] = None


def enable_persistent_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernel-build cache at `path` (else $CRUISE_CONTROL_KERNEL_CACHE,
    else the checkout's build/cruise_control_torch). Returns the directory,
    or None when it cannot be made writable: the cache is an accelerator,
    never a startup requirement, and the build directory is then left as it
    was."""
    global _enabled
    if _enabled is not None:
        return _enabled
    cache_dir = os.path.abspath(
        path or os.environ.get("CRUISE_CONTROL_KERNEL_CACHE", _DEFAULT_DIR)
    )
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return None
    if not os.access(cache_dir, os.W_OK):
        return None
    build.set_build_dir(cache_dir)
    _enabled = cache_dir
    return cache_dir
