"""K3: masked scores of candidate actions under one goal of the default stack.

Replaces cruise_control_tpu/analyzer/acceptance.py score_batch (:330) fed by
actions.build_selected (:189). The CUDA kernel is csrc/score_candidates.cu,
its per-candidate body `score_action` in csrc/score_goal.cuh (shared with K9);
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


def score_context(static, agg, tables, goal, gs, what: str):
    """(tensors, ints): the score context every K3 / K9 launch reads, in the
    order of read_score_ctx (csrc/score_goal.cuh)."""
    dev = agg.assignment.device
    if goal.kernel_id is None:
        raise NotImplementedError(f"{what}: no kernel case for {goal.name}")
    # the capacity goals' usable capacity, PotentialNwOutGoal's limit, and
    # the soft goals' window (per topic for the topic goal); unused
    # arguments get a placeholder
    if hasattr(goal, "limit"):
        limit = goal.limit(static).contiguous()
    elif gs is not None and hasattr(gs, "limit"):
        limit = gs.limit
    else:
        limit = static.host_cpu_capacity_limit
    has_window = gs is not None and hasattr(gs, "upper")
    w_lower = gs.lower.contiguous() if has_window else limit
    w_upper = gs.upper.contiguous() if has_window else limit
    w_active = getattr(gs, "active", None)
    if w_active is None:
        w_active = torch.ones((), dtype=torch.bool, device=dev)
    tensors = (
        agg.assignment, static.part_load, static.topic_id, static.broker_capacity,
        static.broker_rack, static.broker_host, static.dead, static.replica_dst_ok,
        static.leadership_dst_ok, static.movable_partition, static.host_cpu_capacity_limit,
        agg.broker_load, agg.replica_count, agg.leader_count, agg.potential_nw_out,
        agg.leader_nw_in, agg.rack_replica_count, agg.topic_replica_count, agg.host_cpu_load,
        *tables, limit, static.max_replicas_per_broker, w_lower, w_upper, w_active,
    )
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: context tensors must be contiguous and on {dev}")
    ints = (agg.assignment.shape[1], agg.rack_replica_count.shape[1], agg.broker_load.shape[0],
            goal.kernel_id)
    return tensors, ints


def score_candidates(static, agg, tables, goal, gs, p, kind, slot, dst):
    """`score_candidates_plain` for CPU tensors, the CUDA kernel for CUDA
    tensors. The index tensors broadcast to a common shape of rank <= 3 and
    may be strided views; the kernel reads them through their strides."""
    dev = agg.assignment.device
    kind = torch.as_tensor(kind, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        return score_candidates_plain(static, agg, tables, goal, gs, p, kind, slot, dst)
    idx = (p, kind, slot, dst)
    for t, name in zip(idx, ("p", "kind", "slot", "dst")):
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"score_candidates: {name} must be int32 on {dev}")
    shape = torch.broadcast_shapes(*(t.shape for t in idx))
    if len(shape) > 3:
        raise ValueError(f"score_candidates: rank {len(shape)} > 3")
    shape3 = (1,) * (3 - len(shape)) + tuple(shape)
    out = torch.empty(shape3, dtype=torch.float32, device=dev)
    ctx, ctx_ints = score_context(static, agg, tables, goal, gs, "score_candidates")
    strides = [s for t in idx for s in _strides3(t, shape3)]
    lib = build.load("score_candidates")
    code = lib.score_candidates(
        build.ptrs(out, p, kind, slot, dst, *ctx),
        build.ints(*shape3, *strides, *ctx_ints),
        build.stream())
    build.check(lib, code, "score_candidates")
    score_candidates.launches += 1
    return out.reshape(shape)


score_candidates.launches = 0
