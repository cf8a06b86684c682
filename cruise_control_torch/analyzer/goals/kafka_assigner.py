"""Kafka-assigner mode goals.

Drop-in replacements for the legacy kafka-assigner tool, selected when a
request's goal list carries KafkaAssigner-prefixed names
(cc/KafkaCruiseControlUtils.java:193), as the JAX package's
goals/kafka_assigner.py has them:

- KafkaAssignerEvenRackAwareGoal (cc/analyzer/kafkaassigner/
  KafkaAssignerEvenRackAwareGoal.java:41): rack awareness plus strictly even
  replica counts, the rack-aware goal with the replica window pinned to
  [floor(avg), ceil(avg)]; K3 / K9 case 15 (csrc/score_goal.cuh).
- KafkaAssignerDiskUsageDistributionGoal (.../
  KafkaAssignerDiskUsageDistributionGoal.java:45): DiskUsageDistributionGoal
  under another name, K3 / K9 case 11 and the replica swaps.
"""

from __future__ import annotations

import torch

from cruise_control_torch.analyzer.actions import KIND_MOVE, ActionBatch
from cruise_control_torch.analyzer.goals.base import Goal, distribution_score, imbalance
from cruise_control_torch.analyzer.goals.hard import RackAwareGoal, _neg_inf, _zero
from cruise_control_torch.analyzer.goals.soft import ResourceDistributionGoal, WindowState
from cruise_control_torch.common.resources import PartMetric, Resource
from cruise_control_torch.common.xla_math import fma
from cruise_control_torch.kernels.window_sum import window_sum


class KafkaAssignerEvenRackAwareGoal(Goal):
    """Rack-aware and strictly even replica distribution, as one hard goal."""

    name = "KafkaAssignerEvenRackAwareGoal"
    is_hard = True
    kernel_id = 15

    def __init__(self):
        self._rack = RackAwareGoal()

    def prepare(self, static, agg, dims):
        # sums of whole numbers: exact in any order
        n_alive = torch.clamp(torch.sum(static.alive.to(torch.float32)), min=1.0)
        avg = torch.sum(agg.replica_count).to(torch.float32) / n_alive
        return WindowState(lower=torch.floor(avg), upper=torch.ceil(avg),
                           active=torch.tensor(True, device=avg.device))

    def broker_violation(self, static, gs, agg):
        rack_bad = self._rack.broker_violation(static, None, agg)
        c = agg.replica_count.to(torch.float32)
        return rack_bad | (((c > gs.upper) | (c < gs.lower)) & static.alive)

    def cost(self, static, gs, agg):
        dist = imbalance(agg.replica_count.to(torch.float32), gs.lower, gs.upper)
        even = window_sum(torch.where(static.alive, dist, _zero(dist)))
        return self._rack.cost(static, None, agg) + even

    def acceptance(self, static, gs, agg, act: ActionBatch):
        rack_ok = self._rack.acceptance(static, None, agg, act)
        dst_after = (agg.replica_count[act.dst.long()] + 1).to(torch.float32)
        # strict: no move pushes a broker past the even window
        return rack_ok & ((act.kind != KIND_MOVE) | (dst_after <= gs.upper))

    def action_score(self, static, gs, agg, act: ActionBatch):
        rack_score = self._rack.action_score(static, None, agg, act)
        c_src = agg.replica_count[act.src.long()].to(torch.float32)
        c_dst = agg.replica_count[act.dst.long()].to(torch.float32)
        even = distribution_score(c_src, c_dst, c_src - 1.0, c_dst + 1.0, gs.lower, gs.upper,
                                  tiebreak=(c_src - c_dst) * 1e-2)
        return rack_score + torch.where(act.kind == KIND_MOVE, even, _zero(even))

    def dst_preference(self, static, gs, agg):
        return -agg.replica_count.to(torch.float32)

    def src_rank(self, static, gs, agg):
        # rack-violating brokers first, then those above the even window
        rack_rank = self._rack.src_rank(static, None, agg)
        c = agg.replica_count.to(torch.float32)
        over = torch.where(static.alive & (c > gs.upper), c - gs.upper, _neg_inf(c))
        return torch.maximum(torch.where(torch.isfinite(rack_rank), rack_rank + 1e3,
                                         _neg_inf(c)), over)

    def drain_contrib(self, static, gs, agg):
        # rack-violating replicas first, then any replica, the smallest first
        disk = static.part_load[:, PartMetric.DISK]
        viol = self._rack._slot_violation(static, agg)
        return torch.where(viol, fma(-1e-9, disk[:, None], 1.0),
                           (-disk[:, None]).expand(agg.assignment.shape))

    def contribute_acceptance(self, static, gs, tables):
        tables = self._rack.contribute_acceptance(static, None, tables)
        # the even window caps destinations only
        return tables._replace(hi_rep=torch.minimum(tables.hi_rep, gs.upper))


class KafkaAssignerDiskUsageDistributionGoal(ResourceDistributionGoal):
    """Disk balance in kafka-assigner mode: DiskUsageDistributionGoal's code
    (K3 case 8 + DISK) under its kafka-assigner name."""

    def __init__(self):
        super().__init__(Resource.DISK)
        self.name = "KafkaAssignerDiskUsageDistributionGoal"
