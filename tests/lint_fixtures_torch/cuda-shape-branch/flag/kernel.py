# cclint: kernel-module
"""Flagging fixture: concrete sizes pick the launch sequence."""
import torch


def bad(x, agg):
    if x.shape[0] > 64:
        return torch.sum(x)
    if x.numel() > 8:
        return torch.amax(x)
    return torch.amin(x) if len(agg.assignment) else x
