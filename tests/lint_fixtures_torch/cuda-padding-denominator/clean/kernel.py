# cclint: kernel-module
"""Clean fixture: valid-count denominators (padding-invariant)."""
import torch


def good(static, total):
    per_part = total / torch.clamp(static.num_valid_partitions, min=1.0)
    per_broker = total / torch.clamp(torch.sum(static.broker_valid), min=1)
    return per_part + per_broker
