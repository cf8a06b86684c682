"""window_sum: float32 sums in ascending index order.

Replaces the `jnp.sum` reductions of the soft goals' windows and costs
(cruise_control_tpu/analyzer/goals/soft.py :63-64, :462, :516). The CUDA
kernel is csrc/window_sum.cu; `window_sum_plain` is the CPU version. Both
add the elements one at a time in index order, each add rounded to float32:
XLA:CPU's order for up to 32 terms, and one fixed order on every device
beyond that (torch.sum's tree order differs between devices).
"""

from __future__ import annotations

import numpy as np
import torch

from cruise_control_torch.kernels import build


def window_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """f32[...]: the sum over the first axis, sequentially in float32."""
    a = x.detach().cpu().numpy()
    if a.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=torch.float32)
    # add.accumulate runs sequentially in the array's own dtype
    return torch.from_numpy(np.array(np.add.accumulate(a, axis=0)[-1], dtype=np.float32))


def window_sum(x: torch.Tensor) -> torch.Tensor:
    """`window_sum_plain` for a CPU tensor, the CUDA kernel for a CUDA one.
    `x` is f32[n] or f32[n, cols] with cols <= 1024; returns f32[] or
    f32[cols]."""
    if x.dtype != torch.float32 or x.dim() not in (1, 2):
        raise TypeError(f"window_sum: expected f32 of rank 1 or 2, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return window_sum_plain(x)
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
