"""window_sum: float32 sums in XLA:CPU's order.

Replaces the `jnp.sum` reductions of the soft goals' windows and costs
(cruise_control_tpu/analyzer/goals/soft.py :63-64, :84, :412, :462, :474,
:516), the capacity goals' costs (goals/hard.py :198, :206) and the mean
replica load (analyzer/drain.py :214, :278). The CUDA kernel is
csrc/window_sum.cu; `window_sum_plain` is the CPU version. Both add in the
order of XLA:CPU's tree-reduction rewrite (window 32):

- n <= 32 terms are added in index order, starting from +0.0 (one term is
  returned as it is: XLA drops a reduction over one element);
- a longer axis is padded with zeros to m, the next multiple of 32, with
  (m - n) // 2 of them in front and the rest behind; each window of 32 is
  summed in index order from +0.0, and the rewrite repeats on the window sums
  until 32 or fewer remain, which are then added in index order.

Each add rounds to float32. The padding adds +0.0, so a window holding only
-0.0 sums to +0.0, as XLA's does. A reduction over one axis of a matrix takes
each column (or row) in this order on its own.
"""

from __future__ import annotations

import numpy as np
import torch

from cruise_control_torch.kernels import build

#: XLA:CPU's tree-reduction window
WINDOW = 32
#: the longest column the kernel takes: its window sums live in 227 KB of
#: shared memory
MAX_TERMS = 1_800_000


def xla_sum(a: np.ndarray) -> np.ndarray:
    """f32[...]: the sum over the first axis of the float32 array `a`, in
    XLA:CPU's order (module docstring)."""
    a = np.asarray(a, dtype=np.float32)
    if a.shape[0] == 1:
        return a[0]
    while a.shape[0] > WINDOW:
        n = a.shape[0]
        m = -(-n // WINDOW) * WINDOW
        lo = (m - n) // 2
        a = np.pad(a, [(lo, m - n - lo)] + [(0, 0)] * (a.ndim - 1))
        a = a.reshape((m // WINDOW, WINDOW) + a.shape[1:])
        acc = np.zeros((m // WINDOW,) + a.shape[2:], dtype=np.float32)
        for k in range(WINDOW):
            acc = acc + a[:, k]
        a = acc
    acc = np.zeros(a.shape[1:], dtype=np.float32)
    for k in range(a.shape[0]):
        acc = acc + a[k]
    return acc


def window_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """f32[...]: the sum over the first axis, in XLA:CPU's order."""
    return torch.from_numpy(np.array(xla_sum(x.detach().cpu().numpy()), dtype=np.float32))


def window_sum(x: torch.Tensor) -> torch.Tensor:
    """`window_sum_plain` for a CPU tensor, the CUDA kernel for a CUDA one.
    `x` is f32[n] or f32[n, cols]; returns f32[] or f32[cols]."""
    if x.dtype != torch.float32 or x.dim() not in (1, 2):
        raise TypeError(f"window_sum: expected f32 of rank 1 or 2, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return window_sum_plain(x)
    if x.shape[0] > MAX_TERMS:
        raise ValueError(f"window_sum: {x.shape[0]} terms, the kernel takes at most {MAX_TERMS}")
    x = x.contiguous()
    cols = 1 if x.dim() == 1 else x.shape[1]
    build.require(x.reshape(x.shape[0], cols), torch.float32, 2, "x", x.device)
    out = torch.empty(cols, dtype=torch.float32, device=x.device)
    lib = build.load("window_sum")
    code = lib.window_sum(build.ptrs(x, out), build.ints(x.shape[0], cols), build.stream())
    build.check(lib, code, "window_sum")
    window_sum.launches += 1
    return out.reshape(x.shape[1:])


window_sum.launches = 0
