"""K2: each broker's top-k replica slots by drain priority.

Replaces cruise_control_tpu/analyzer/drain.py broker_top_replicas (:74).
The CUDA kernel is csrc/broker_topk.cu; `broker_topk_plain` is the PyTorch
version.
"""

from __future__ import annotations

import torch

from cruise_control_torch.kernels import build

#: slots a block of the kernel's first launch takes
CHUNK = 4096
#: per device: (runs, keys) scratch of the kernel, grown on demand; nothing
#: in it outlives a call. Calls on one stream use it in turn.
_SCRATCH = {}
_ARGTYPES = (build.PTR,) * 8 + (build.INT,) * 6 + (build.PTR,)


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


def _refuse(contrib, assignment, movable_partition):
    """Raise the first reason the kernel does not take these inputs."""
    dev = contrib.device
    build.require(contrib, torch.float32, 2, "contrib", dev)
    build.require(assignment, torch.int32, 2, "assignment", dev)
    build.require(movable_partition, torch.bool, 1, "movable_partition", dev)
    raise ValueError("broker_topk: contrib, assignment and movable_partition disagree")


def _scratch(dev: int, b: int, blocks: int):
    """The device's (runs, keys) scratch, grown to these sizes."""
    ws = _SCRATCH.get(dev)
    # cclint: disable=cuda-shape-branch -- the workspace grows once to the largest size seen; the launches are the same either way
    if ws is None or ws[0].numel() < blocks * b or ws[1].numel() < blocks * CHUNK:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        cuda = torch.device("cuda", dev)
        ws = (torch.empty(max(blocks * b, old[0]), dtype=torch.int32, device=cuda),
              torch.empty(max(blocks * CHUNK, old[1]), dtype=torch.int64, device=cuda))
        _SCRATCH[dev] = ws
    return ws


def broker_topk(contrib, assignment, movable_partition, k: int, num_brokers: int,
                heaviest: bool = True):
    """`broker_topk_plain` for CPU tensors, the CUDA kernel for CUDA tensors.
    Up to 32,768 brokers a block of the kernel's first launch counts its
    slots by broker in shared memory (128 KB, beside its CHUNK keys' 32 KB);
    above, in its own row of the runs table (a second launch configuration
    of the same kernel): any broker count below 2**31."""
    if contrib.device.type == "cpu":
        return broker_topk_plain(contrib, assignment, movable_partition, k, num_brokers,
                                 heaviest)
    dev = contrib.device
    # cclint: disable=cuda-shape-branch -- a guard that refuses what the kernel does not take; it picks no launch sequence
    if not (contrib.is_cuda and contrib.dtype == torch.float32 and assignment.dtype == torch.int32
            and movable_partition.dtype == torch.bool and contrib.dim() == 2
            and movable_partition.dim() == 1 and contrib.shape == assignment.shape
            and movable_partition.shape[0] == assignment.shape[0]
            and assignment.device == dev and movable_partition.device == dev
            and contrib.is_contiguous() and assignment.is_contiguous()
            and movable_partition.is_contiguous()):
        _refuse(contrib, assignment, movable_partition)
    p_count, r = assignment.shape
    n = p_count * r
    if k < 1 or n >= 2**32:
        raise ValueError("broker_topk: needs k >= 1 and fewer than 2**32 slots")
    if num_brokers >= 2**31:
        raise ValueError(f"broker_topk: {num_brokers} brokers, the kernel takes fewer than 2**31")
    blocks = max(1, -(-n // CHUNK))
    idx = contrib.get_device()
    runs, keys = _scratch(idx, num_brokers, blocks)
    out = torch.empty((2, num_brokers, k), dtype=torch.int32, device=dev)
    out_ok = torch.empty((num_brokers, k), dtype=torch.bool, device=dev)
    code = build.entry("broker_topk", _ARGTYPES)(
        contrib.data_ptr(), assignment.data_ptr(), movable_partition.data_ptr(), runs.data_ptr(),
        keys.data_ptr(), out.data_ptr(), out.data_ptr() + 4 * num_brokers * k, out_ok.data_ptr(),
        p_count, r, num_brokers, k, 1 if heaviest else 0, blocks, build.raw_stream(idx))
    if code:
        build.check(build.load("broker_topk"), code, "broker_topk")
    broker_topk.launches += 1
    out_p, out_s = out.unbind(0)
    return out_p, out_s, out_ok


broker_topk.launches = 0
