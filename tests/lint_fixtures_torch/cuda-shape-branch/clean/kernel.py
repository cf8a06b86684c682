# cclint: kernel-module
"""Clean fixture: sizes from Dims, data branches by where, a refusing guard."""
import torch


def good(x, dims, mask, n):
    if x.shape[0] != n:
        raise ValueError("x must hold n rows")  # a guard picks no launches
    k = min(8, dims.num_brokers)  # a static Python int from Dims
    return torch.where(mask, x, 0.0).sum() + k
