"""Hard goals: rack awareness, replica capacity, resource capacity.

  RackAwareGoal          cc/analyzer/goals/RackAwareGoal.java:40
  ReplicaCapacityGoal    cc/analyzer/goals/ReplicaCapacityGoal.java:37
  CapacityGoal + Disk/NetworkIn/NetworkOut/Cpu
                         cc/analyzer/goals/CapacityGoal.java:39
CPU capacity is enforced at host level as well as broker level.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cruise_control_torch.analyzer.actions import KIND_MOVE, ActionBatch, slot_contrib
from cruise_control_torch.analyzer.context import utilization
from cruise_control_torch.analyzer.goals.base import SCORE_EPS, BulkCounts, Goal
from cruise_control_torch.common.resources import PartMetric, Resource
from cruise_control_torch.common.xla_math import fma, xla_tanh
from cruise_control_torch.kernels.window_sum import EXCESS_COST, window_sum


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(-torch.inf, dtype=torch.float32, device=like.device)


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=like.device)


class RackAwareGoal(Goal):
    """No two replicas of a partition on the same rack."""

    name = "RackAwareGoal"
    is_hard = True
    kernel_id = 0

    def _slot_violation(self, static, agg):
        """bool[P, R]: slot sits on a rack that hosts >1 replica of its partition."""
        a = agg.assignment
        valid = a >= 0
        rack = static.broker_rack[torch.where(valid, a, 0).long()]
        count = torch.gather(agg.rack_replica_count, 1, rack.long())
        return valid & (count > 1)

    def _per_broker(self, static, agg, values, reduce):
        b = static.alive.shape[0]
        seg = torch.where(agg.assignment >= 0, agg.assignment, b).reshape(-1).long()
        out = torch.zeros(b + 1, dtype=values.dtype, device=values.device)
        return out.scatter_reduce(0, seg, values.reshape(-1), reduce)[:b]

    def broker_violation(self, static, gs, agg):
        viol = self._per_broker(static, agg, self._slot_violation(static, agg).to(torch.int32), "amax")
        return (viol > 0) & static.alive

    def cost(self, static, gs, agg):
        return torch.sum(self._slot_violation(static, agg).to(torch.float32))

    def acceptance(self, static, gs, agg, act: ActionBatch):
        is_move = act.kind == KIND_MOVE
        rack_src = static.broker_rack[act.src.long()]
        rack_dst = static.broker_rack[act.dst.long()]
        count_dst = agg.rack_replica_count[act.p.long(), rack_dst.long()] - (rack_src == rack_dst).to(torch.int32)
        return torch.where(is_move, count_dst == 0, True)

    def action_score(self, static, gs, agg, act: ActionBatch):
        rack_src = static.broker_rack[act.src.long()]
        dup = agg.rack_replica_count[act.p.long(), rack_src.long()] > 1
        is_move = act.kind == KIND_MOVE
        util = torch.amax(utilization(agg, static), dim=1)
        tiebreak = (1e-3 * (1.0 - xla_tanh(util)))[act.dst.long()]
        return torch.where(is_move & dup, 1.0 + tiebreak, _zero(tiebreak))

    def src_rank(self, static, gs, agg):
        # an exact count of violating slots per broker (sums of 0/1 in f32)
        nviol = self._per_broker(static, agg, self._slot_violation(static, agg).to(torch.float32), "sum")
        return torch.where(static.alive & (nviol > 0), nviol, _neg_inf(nviol))

    def drain_contrib(self, static, gs, agg):
        disk = static.part_load[:, PartMetric.DISK]
        viol = self._slot_violation(static, agg)
        return torch.where(viol, fma(-1e-9, disk[:, None], 1.0), _neg_inf(disk))

    def contribute_acceptance(self, static, gs, tables):
        return tables._replace(rack_enabled=torch.tensor(True, device=tables.hi_rep.device))


class ReplicaCapacityGoal(Goal):
    """Replica count per broker <= max.replicas.per.broker."""

    name = "ReplicaCapacityGoal"
    is_hard = True
    count_family = True
    kernel_id = 1

    def broker_violation(self, static, gs, agg):
        return (agg.replica_count > static.max_replicas_per_broker) & static.alive

    def cost(self, static, gs, agg):
        over = torch.clamp(agg.replica_count - static.max_replicas_per_broker, min=0)
        return torch.sum(torch.where(static.alive, over, 0).to(torch.float32))

    def acceptance(self, static, gs, agg, act: ActionBatch):
        is_move = act.kind == KIND_MOVE
        fits = agg.replica_count[act.dst.long()] + 1 <= static.max_replicas_per_broker
        return torch.where(is_move, fits, True)

    def action_score(self, static, gs, agg, act: ActionBatch):
        is_move = act.kind == KIND_MOVE
        over = agg.replica_count[act.src.long()] > static.max_replicas_per_broker
        headroom = (static.max_replicas_per_broker - agg.replica_count[act.dst.long()]).to(torch.float32)
        score = fma(1e-3, xla_tanh(headroom * 1e-3), 1.0)
        return torch.where(is_move & over, score, _zero(score))

    def dst_preference(self, static, gs, agg):
        return -agg.replica_count.to(torch.float32)

    def src_rank(self, static, gs, agg):
        over = (agg.replica_count - static.max_replicas_per_broker).to(torch.float32)
        return torch.where(static.alive & (over > 0), over, _neg_inf(over))

    def drain_contrib(self, static, gs, agg):
        disk = static.part_load[:, PartMetric.DISK]
        return (-disk[:, None]).expand(agg.assignment.shape)

    def bulk_counts(self, static, gs, agg):
        c = agg.replica_count.to(torch.float32)
        cap = static.max_replicas_per_broker.to(torch.float32)
        surplus = torch.where(static.dead, c, torch.clamp(c - cap, min=0.0))
        headroom = cap - c
        dst_key = torch.where(static.replica_dst_ok & (headroom > 0.0), headroom, _neg_inf(c))
        return BulkCounts(surplus=surplus, dst_key=dst_key)

    def contribute_acceptance(self, static, gs, tables):
        cap = static.max_replicas_per_broker.to(torch.float32)
        return tables._replace(hi_rep=torch.minimum(tables.hi_rep, cap))


class CapacityGoalState(NamedTuple):
    limit: torch.Tensor  # f32[B] usable capacity for this resource


#: K3 case of each capacity goal, by resource (csrc/score_candidates.cu)
_CAPACITY_KERNEL_ID = {Resource.DISK: 2, Resource.NW_IN: 3, Resource.NW_OUT: 4, Resource.CPU: 5}


class CapacityGoal(Goal):
    """Broker utilization of one resource <= capacity * capacity.threshold;
    for CPU the same bound also holds for the host-level sum."""

    is_hard = True

    def __init__(self, resource: Resource):
        self.resource = int(resource)
        self.name = {
            Resource.DISK: "DiskCapacityGoal",
            Resource.NW_IN: "NetworkInboundCapacityGoal",
            Resource.NW_OUT: "NetworkOutboundCapacityGoal",
            Resource.CPU: "CpuCapacityGoal",
        }[Resource(resource)]
        self.uses_leadership = resource in (Resource.CPU, Resource.NW_OUT)
        self.kernel_id = _CAPACITY_KERNEL_ID[Resource(resource)]

    def prepare(self, static, agg, dims):
        return CapacityGoalState(limit=static.capacity_limit[:, self.resource].contiguous())

    def _host_over(self, static, agg):
        return agg.host_cpu_load > static.host_cpu_capacity_limit

    def broker_violation(self, static, gs, agg):
        over = agg.broker_load[:, self.resource] > gs.limit
        if self.resource == Resource.CPU:
            over = over | self._host_over(static, agg)[static.broker_host.long()]
        return over & static.alive

    def cost(self, static, gs, agg):
        excess = torch.clamp(agg.broker_load[:, self.resource] - gs.limit, min=0.0)
        total = window_sum(torch.where(static.alive, excess, _zero(excess)), EXCESS_COST)
        if self.resource == Resource.CPU:
            total = total + window_sum(
                torch.clamp(agg.host_cpu_load - static.host_cpu_capacity_limit, min=0.0))
        return total

    def acceptance(self, static, gs, agg, act: ActionBatch):
        src, dst = act.src.long(), act.dst.long()
        dres = act.dload[..., self.resource]
        after = agg.broker_load[dst, self.resource] + dres
        ok = (after <= gs.limit[dst]) | (dres <= 0)
        if self.resource == Resource.CPU:
            host_src = static.broker_host[src]
            host_dst = static.broker_host[dst]
            h_after = agg.host_cpu_load[host_dst.long()] + torch.where(
                host_src == host_dst, _zero(dres), dres)
            host_ok = h_after <= static.host_cpu_capacity_limit[host_dst.long()]
            ok = ok & (host_ok | (dres <= 0))
        return ok

    def action_score(self, static, gs, agg, act: ActionBatch):
        src = act.src.long()
        dres = act.dload[..., self.resource]
        src_over = agg.broker_load[src, self.resource] > gs.limit[src]
        if self.resource == Resource.CPU:
            host_over = self._host_over(static, agg)
            src_over = src_over | host_over[static.broker_host[src].long()]
        return torch.where(src_over & (dres > SCORE_EPS), dres, _zero(dres))

    def dst_preference(self, static, gs, agg):
        return gs.limit - agg.broker_load[:, self.resource]

    def src_rank(self, static, gs, agg):
        excess = agg.broker_load[:, self.resource] - gs.limit
        over = excess > 0.0
        if self.resource == Resource.CPU:
            host = static.broker_host.long()
            over = over | self._host_over(static, agg)[host]
            excess = torch.maximum(
                excess, (agg.host_cpu_load - static.host_cpu_capacity_limit)[host])
        return torch.where(static.alive & over, excess, _neg_inf(excess))

    def drain_contrib(self, static, gs, agg):
        return slot_contrib(static.part_load, agg.assignment, self.resource)

    def contribute_acceptance(self, static, gs, tables):
        hi = tables.hi_load.clone()
        hi[:, self.resource] = torch.minimum(hi[:, self.resource], gs.limit)
        tables = tables._replace(hi_load=hi)
        if self.resource == Resource.CPU:
            tables = tables._replace(
                hi_host_cpu=torch.minimum(tables.hi_host_cpu, static.host_cpu_capacity_limit))
        return tables
