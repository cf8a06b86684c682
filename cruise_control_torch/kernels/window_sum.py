"""window_sum: float32 sums in XLA:CPU's order.

Replaces the `jnp.sum` reductions of the soft goals' windows and costs
(cruise_control_tpu/analyzer/goals/soft.py :63-64, :84, :412, :462, :474,
:516), the capacity goals' costs (goals/hard.py :198, :206) and the mean
replica load (analyzer/drain.py :214, :278). The CUDA kernel is
csrc/window_sum.cu; `window_sum_plain` (`xla_order_sum`) is the PyTorch
version and `xla_sum` the same in numpy, the tests' spec. All add in the
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
#: per device: the kernel's scratch (f32, every level's window sums) and its
#: column tiles' tickets (int32, 0 between launches), grown on demand, with
#: their addresses. Calls on one stream use them in turn.
_SCRATCH = {}
_ARGTYPES = (build.PTR,) * 4 + (build.INT, build.INT, build.PTR)


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


def xla_order_sum(x: torch.Tensor) -> torch.Tensor:
    """f32[...]: the sum over the first axis of the float32 tensor `x`, in
    XLA:CPU's order (module docstring), on `x`'s device: `xla_sum` in
    PyTorch."""
    if x.shape[0] == 1:
        return x[0].clone()
    while x.shape[0] > WINDOW:
        n = x.shape[0]
        m = -(-n // WINDOW) * WINDOW
        lo = (m - n) // 2
        padded = x.new_zeros((m,) + tuple(x.shape[1:]))
        padded[lo:lo + n] = x
        w = padded.reshape((m // WINDOW, WINDOW) + tuple(x.shape[1:]))
        acc = torch.zeros_like(w[:, 0])
        for k in range(WINDOW):
            acc.add_(w[:, k])
        x = acc
    acc = x.new_zeros(x.shape[1:])
    for k in range(x.shape[0]):
        acc.add_(x[k])
    return acc


def window_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """f32[...]: the sum over the first axis, in XLA:CPU's order."""
    return xla_order_sum(x.detach())


def _scratch(dev: int, floats: int, tiles: int):
    """(scratch, tickets, their addresses) of device `dev`, grown to these sizes."""
    ws = _SCRATCH.get(dev)
    if ws is None or ws[0].numel() < floats or ws[1].numel() < tiles:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        cuda = torch.device("cuda", dev)
        scratch = torch.empty(max(floats, old[0], 1 << 16), dtype=torch.float32, device=cuda)
        tickets = torch.zeros(max(tiles, old[1], 64), dtype=torch.int32, device=cuda)
        ws = _SCRATCH[dev] = (scratch, tickets, scratch.data_ptr(), tickets.data_ptr())
    return ws


def window_sum(x: torch.Tensor) -> torch.Tensor:
    """`window_sum_plain` for a CPU tensor, the CUDA kernel for a CUDA one.
    `x` is f32[n] or f32[n, cols], n < 2**31; returns f32[] or f32[cols].
    Past 65,535 column tiles (of up to 32 columns), each row of the grid
    takes its tiles in turn."""
    if x.dtype != torch.float32 or x.dim() not in (1, 2):
        raise TypeError(f"window_sum: expected f32 of rank 1 or 2, got {x.dtype} {tuple(x.shape)}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return window_sum_plain(x)
        raise ValueError(f"window_sum: expected a CPU or CUDA tensor, got {x.device}")
    n = x.shape[0]
    if not x.is_contiguous():
        x = x.contiguous()
    cols = x.shape[1] if x.dim() == 2 else 1
    dev = x.get_device()
    ws = _scratch(dev, (n // 16 + 8) * cols, (cols + 31) // 32)
    out = x.new_empty((cols,) if x.dim() == 2 else ())
    code = build.entry("window_sum", _ARGTYPES)(x.data_ptr(), out.data_ptr(), ws[2], ws[3], n,
                                                cols, build.raw_stream(dev))
    if code:
        build.check(build.load("window_sum"), code, "window_sum")
    window_sum.launches += 1
    return out


window_sum.launches = 0
