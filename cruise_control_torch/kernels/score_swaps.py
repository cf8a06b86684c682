"""K5: validation and improvement of coupled two-leg actions.

Replaces the JAX package's swap validations, all built on
acceptance.swap_tables_acceptance (:234):
  REPLICA_SWAP      swaps.make_swap_round, the round-start grid (:98-194)
                    and each wave's re-validation (:255-282)
  TOPIC_SWAP        drain.make_topic_swap_round.validate (:485)
  LEADERSHIP_RELAY  drain.make_leadership_relay_round.validate (:692)
Each cell is (p1, s1, b, p2, s2, d): replica (p1, s1) of broker b against
(p2, s2) of broker d for the swaps; for a relay, leadership of p1 moves
b -> d through its slot s1 and leadership of p2 moves d -> the broker in
its slot s2. The six index tensors broadcast to one shape of rank <= 5 and
are read through their strides. The result is the cell's improvement, -inf
where it is not ok; a negative p1, p2, b or d masks the cell.

The CUDA kernel is csrc/score_swaps.cu; the plain versions are
swaps.replica_swap_grid / replica_swap_revalidate and drain.topic_swap_validate
/ relay_validate.
"""

from __future__ import annotations

import torch

from cruise_control_torch.kernels import build

REPLICA_SWAP = 0
TOPIC_SWAP = 1
LEADERSHIP_RELAY = 2


def score_swaps_plain(kind: int, static, agg, tables, gs, p1, s1, b, p2, s2, d,
                      resource: int = 0, wave: bool = False):
    """f32[broadcast shape]: the improvement of each cell, -inf where not ok."""
    from cruise_control_torch.analyzer import drain, swaps

    if kind == REPLICA_SWAP:
        fn = swaps.replica_swap_revalidate if wave else swaps.replica_swap_grid
        return fn(static, agg, tables, gs, resource, p1, s1, b, p2, s2, d)
    fn = drain.topic_swap_validate if kind == TOPIC_SWAP else drain.relay_validate
    return fn(static, agg, tables, gs, p1, s1, b, p2, s2, d)


def _strides(t: torch.Tensor, shape) -> list:
    """Element strides of `t` broadcast to `shape` (0 on broadcast axes)."""
    while t.dim() < len(shape):
        t = t.unsqueeze(0)
    return list(t.expand(shape).stride())


def score_swaps(kind, static, agg, tables, gs, p1, s1, b, p2, s2, d, resource: int = 0,
                wave: bool = False):
    """`score_swaps_plain` for CPU tensors, the CUDA kernel for CUDA tensors.
    `kind` is REPLICA_SWAP, TOPIC_SWAP or LEADERSHIP_RELAY (an int or a 0-d
    tensor); `wave` selects REPLICA_SWAP's re-validation form."""
    kind = int(kind)
    dev = agg.assignment.device
    idx = tuple(t.to(torch.int32) for t in (p1, s1, b, p2, s2, d))
    if dev.type == "cpu":
        return score_swaps_plain(kind, static, agg, tables, gs, *idx, resource=resource,
                                 wave=wave)
    for t, name in zip(idx, ("p1", "s1", "b", "p2", "s2", "d")):
        if t.device != dev:
            raise TypeError(f"score_swaps: {name} must be on {dev}")
    shape = torch.broadcast_shapes(*(t.shape for t in idx))
    if len(shape) > 5:
        raise ValueError(f"score_swaps: rank {len(shape)} > 5")
    shape5 = (1,) * (5 - len(shape)) + tuple(shape)
    out = torch.empty(shape5, dtype=torch.float32, device=dev)
    lower = gs.lower.to(torch.float32).contiguous()
    upper = gs.upper.to(torch.float32).contiguous()
    active = getattr(gs, "active", torch.ones((), dtype=torch.bool, device=dev))
    tensors = (
        agg.assignment, static.part_load, static.topic_id, static.broker_capacity,
        static.capacity_limit, static.broker_rack, static.broker_host, static.movable_partition,
        static.replica_dst_ok, static.leadership_dst_ok,
        agg.broker_load, agg.leader_count, agg.potential_nw_out, agg.leader_nw_in,
        agg.rack_replica_count, agg.topic_replica_count, agg.host_cpu_load,
        tables.hi_load, tables.lo_load, tables.band_hi, tables.band_lo, tables.band_on,
        tables.hi_lead, tables.lo_lead, tables.hi_pnw, tables.hi_lnw, tables.hi_topic,
        tables.lo_topic, tables.hi_host_cpu, tables.rack_enabled, lower, upper, active,
        static.only_move_immigrants,
    )
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("score_swaps: context tensors must be contiguous and on " + str(dev))
    strides = [s for t in idx for s in _strides(t, shape5)]
    lib = build.load("score_swaps")
    code = lib.score_swaps(
        build.ptrs(out, *idx, *tensors),
        build.ints(*shape5, *strides, agg.assignment.shape[1], agg.rack_replica_count.shape[1],
                   agg.broker_load.shape[0], kind, int(resource), 1 if wave else 0,
                   1 if lower.dim() else 0),
        build.stream())
    build.check(lib, code, "score_swaps")
    score_swaps.launches += 1
    return out.reshape(shape)


score_swaps.launches = 0
