# cclint: kernel-module
"""Clean fixture: on-device math, plain-name casts, sizes, host code elsewhere."""
import torch


def good(scores, table, mask, k):
    width = int(k)  # plain-name cast: a Python int, no sync
    rows = int(table.shape[0])  # a size, not a tensor's value
    scale = float(1 << 24)  # a constant expression
    kept = torch.where(mask, scores, torch.zeros_like(scores))
    return kept.max() + table.sum() * scale + width + rows
