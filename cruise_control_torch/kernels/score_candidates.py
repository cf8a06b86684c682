"""K3: masked scores of candidate actions under one hard goal.

Replaces cruise_control_tpu/analyzer/acceptance.py score_batch (:330) fed by
actions.build_selected (:189). The CUDA kernel is csrc/score_candidates.cu;
`score_candidates_plain` (= build_selected + acceptance.score_batch) is the
PyTorch version.
"""

from __future__ import annotations

import torch

from cruise_control_torch.analyzer.acceptance import score_batch
from cruise_control_torch.analyzer.actions import build_selected
from cruise_control_torch.kernels import build


def score_candidates_plain(static, agg, tables, goal, gs, p, kind, slot, dst):
    """f32[broadcast shape]: the score of each (p, kind, slot, dst) action,
    -inf where it is not acceptable."""
    act = build_selected(static.part_load, agg.assignment, p, kind, slot, dst)
    return score_batch(static, agg, act, goal, gs, tables)


def _strides3(t: torch.Tensor, shape3) -> list:
    """Element strides of `t` broadcast to the rank-3 `shape3` (0 on
    broadcast axes)."""
    while t.dim() < 3:
        t = t.unsqueeze(0)
    return list(t.expand(shape3).stride())


def score_candidates(static, agg, tables, goal, gs, p, kind, slot, dst):
    """`score_candidates_plain` for CPU tensors, the CUDA kernel for CUDA
    tensors. The index tensors broadcast to a common shape of rank <= 3 and
    may be strided views; the kernel reads them through their strides."""
    dev = agg.assignment.device
    kind = torch.as_tensor(kind, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        return score_candidates_plain(static, agg, tables, goal, gs, p, kind, slot, dst)
    if goal.kernel_id is None:
        raise NotImplementedError(f"score_candidates: no kernel case for {goal.name}")
    idx = (p, kind, slot, dst)
    for t, name in zip(idx, ("p", "kind", "slot", "dst")):
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"score_candidates: {name} must be int32 on {dev}")
    shape = torch.broadcast_shapes(*(t.shape for t in idx))
    if len(shape) > 3:
        raise ValueError(f"score_candidates: rank {len(shape)} > 3")
    shape3 = (1,) * (3 - len(shape)) + tuple(shape)
    out = torch.empty(shape3, dtype=torch.float32, device=dev)
    limit = gs.limit if gs is not None else static.host_cpu_capacity_limit
    tensors = (
        static.part_load, static.topic_id, static.broker_capacity, static.broker_rack,
        static.broker_host, static.dead, static.replica_dst_ok, static.leadership_dst_ok,
        static.movable_partition, static.host_cpu_capacity_limit,
        agg.broker_load, agg.replica_count, agg.leader_count, agg.potential_nw_out,
        agg.leader_nw_in, agg.rack_replica_count, agg.topic_replica_count, agg.host_cpu_load,
        *tables, limit, static.max_replicas_per_broker,
    )
    for t in (agg.assignment, *tensors):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("score_candidates: context tensors must be contiguous and on " + str(dev))
    strides = [s for t in idx for s in _strides3(t, shape3)]
    lib = build.load("score_candidates")
    code = lib.score_candidates(
        build.ptrs(out, p, kind, slot, dst, agg.assignment, *tensors),
        build.ints(*shape3, *strides, agg.assignment.shape[1], agg.rack_replica_count.shape[1],
                   agg.broker_load.shape[0], goal.kernel_id),
        build.stream())
    build.check(lib, code, "score_candidates")
    score_candidates.launches += 1
    return out.reshape(shape)


score_candidates.launches = 0
