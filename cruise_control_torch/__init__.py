"""PyTorch/CUDA port of the cluster-rebalancing optimizer.

Mirrors the module layout of the JAX package beside it; plain tensor code is
PyTorch, and the device functions on the proposal path are hand-written CUDA
kernels for Hopper (`kernels/`, sources in `csrc/`). Every kernel keeps a
plain PyTorch version that runs for CPU tensors.
"""

from cruise_control_torch.common.resources import Resource  # noqa: F401
