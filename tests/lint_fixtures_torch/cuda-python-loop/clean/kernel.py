# cclint: kernel-module
"""Clean fixture: loops over static config, vectorized axis math."""
import torch


def good(loads, goals):
    for g in goals:  # static goal list: a fixed, tiny stack
        loads = g.apply(loads)
    return torch.sum(loads)
