# cclint: kernel-module
"""Flagging fixture: host syncs inside round code."""
import numpy as np
import torch


def bad(scores, table, mask):
    best = scores.max().item()
    host = table.cpu()
    values = table.tolist()
    rows = np.asarray(table)
    width = int(table.sum() * 2)
    hit = bool(torch.any(mask))
    idx = torch.nonzero(mask)
    picked = torch.masked_select(scores, mask)
    torch.cuda.synchronize()
    return best, host, values, rows, width, hit, idx, picked
