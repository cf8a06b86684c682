"""K2: each broker's top-k replica slots by drain priority.

Replaces cruise_control_tpu/analyzer/drain.py broker_top_replicas (:74).
The CUDA kernel is csrc/broker_topk.cu; `broker_topk_plain` is the PyTorch
version.
"""

from __future__ import annotations

import torch

from cruise_control_torch.kernels import build


def broker_topk_plain(contrib, assignment, movable_partition, k: int, num_brokers: int,
                      heaviest: bool = True):
    """(p, slot, valid), each [B, k]: every broker's top-k slots by `contrib`
    (descending when `heaviest`, ascending otherwise), ties to the lowest flat
    index. Empty, immovable and non-finite slots never surface; where a broker
    has fewer than k, `valid` is False and (p, slot) point at the last slot."""
    p_count, r = assignment.shape
    n = p_count * r
    dev = assignment.device
    included = movable_partition[:, None] & (assignment >= 0) & torch.isfinite(contrib)
    seg = torch.where(included, assignment, num_brokers).reshape(n).long()
    neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
    val = torch.where(included, contrib if heaviest else -contrib, neg_inf).reshape(n)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    taken = torch.zeros(n, dtype=torch.bool, device=dev)
    ps, ss, ok = [], [], []
    for _ in range(k):
        v = torch.where(taken, neg_inf, val)
        best = torch.full((num_brokers + 1,), -torch.inf, dtype=torch.float32, device=dev)
        best = best.scatter_reduce(0, seg, v, "amax")
        is_best = (v == best[seg]) & torch.isfinite(v)
        idx_best = torch.full((num_brokers + 1,), n, dtype=torch.int64, device=dev)
        idx_best = idx_best.scatter_reduce(0, seg, torch.where(is_best, pos, n), "amin")
        idx_best = idx_best[:num_brokers]
        found = idx_best < n
        sel = torch.clamp(idx_best, max=n - 1)
        ps.append((sel // r).to(torch.int32))
        ss.append((sel % r).to(torch.int32))
        ok.append(found)
        full_idx = torch.cat([idx_best, torch.full((1,), n, dtype=torch.int64, device=dev)])
        taken = taken | (pos == full_idx[seg])
    return torch.stack(ps, dim=1), torch.stack(ss, dim=1), torch.stack(ok, dim=1)


def broker_topk(contrib, assignment, movable_partition, k: int, num_brokers: int,
                heaviest: bool = True):
    """`broker_topk_plain` for CPU tensors, the CUDA kernel for CUDA tensors."""
    if contrib.device.type == "cpu":
        return broker_topk_plain(contrib, assignment, movable_partition, k, num_brokers,
                                 heaviest)
    dev = contrib.device
    build.require(contrib, torch.float32, 2, "contrib", dev)
    build.require(assignment, torch.int32, 2, "assignment", dev)
    build.require(movable_partition, torch.bool, 1, "movable_partition", dev)
    p_count, r = assignment.shape
    if contrib.shape != assignment.shape or movable_partition.shape[0] != p_count:
        raise ValueError("broker_topk: contrib, assignment and movable_partition disagree")
    if k < 1 or p_count * r >= 2**32:
        raise ValueError("broker_topk: needs k >= 1 and fewer than 2**32 slots")
    keys = torch.empty(num_brokers, dtype=torch.int64, device=dev)
    taken = torch.empty(p_count * r, dtype=torch.uint8, device=dev)
    out_p = torch.empty((num_brokers, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((num_brokers, k), dtype=torch.int32, device=dev)
    out_ok = torch.empty((num_brokers, k), dtype=torch.bool, device=dev)
    lib = build.load("broker_topk")
    code = lib.broker_topk(
        build.ptrs(contrib, assignment, movable_partition, keys, taken, out_p, out_s, out_ok),
        build.ints(p_count, r, num_brokers, k, 1 if heaviest else 0), build.stream())
    build.check(lib, code, "broker_topk")
    broker_topk.launches += 1
    return out_p, out_s, out_ok


broker_topk.launches = 0
