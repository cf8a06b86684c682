"""Goal SPI: each goal is a set of vectorized functions over tensors.

The counterpart of the reference Goal interface (cc/analyzer/goals/Goal.java:38)
with the batch hooks of the JAX package's goals/base.py:

  prepare           ~ initGoalState: thresholds from the current aggregates
  broker_violation  ~ brokersToBalance, as a bool[B] mask
  acceptance        ~ actionAcceptance over an ActionBatch
  action_score      ~ the improvement the greedy loop pursues (> 0 helps)
  dst_preference    ~ the candidate-broker sort of GoalUtils.eligibleBrokers
  cost              ~ clusterModelStatsComparator, as a scalar
  src_rank / drain_contrib / dst_candidates: the drain round's hooks
"""

from __future__ import annotations

from typing import Any

import torch

from cruise_control_torch.analyzer.actions import ActionBatch, _follower_vec, _leader_vec
from cruise_control_torch.analyzer.context import Aggregates, StaticCtx, utilization

#: Margin factor applied inside balance thresholds (BALANCE_MARGIN = 0.9).
BALANCE_MARGIN = 0.9

#: Minimum action score considered a real improvement (float32 noise floor).
SCORE_EPS = 1e-6


class Goal:
    name: str = ""
    is_hard: bool = False
    #: also nominate promotions from the [P, R-1] leadership grid each round
    uses_leadership: bool = False
    #: floor/ceil count goal, drained by the bulk planner when it is on
    count_family: bool = False
    #: the goal's case in kernel K3 (csrc/score_candidates.cu); None = the
    #: kernel does not score this goal
    kernel_id = None

    def prepare(self, static: StaticCtx, agg: Aggregates, dims) -> Any:
        return None

    def broker_violation(self, static: StaticCtx, gs, agg: Aggregates) -> torch.Tensor:
        raise NotImplementedError

    def cost(self, static: StaticCtx, gs, agg: Aggregates) -> torch.Tensor:
        raise NotImplementedError

    def acceptance(self, static: StaticCtx, gs, agg: Aggregates, act: ActionBatch) -> torch.Tensor:
        raise NotImplementedError

    def contribute_acceptance(self, static: StaticCtx, gs, tables):
        raise NotImplementedError

    def action_score(self, static: StaticCtx, gs, agg: Aggregates, act: ActionBatch) -> torch.Tensor:
        raise NotImplementedError

    def dst_preference(self, static: StaticCtx, gs, agg: Aggregates) -> torch.Tensor:
        return -torch.amax(utilization(agg, static), dim=1)

    def src_rank(self, static: StaticCtx, gs, agg: Aggregates) -> torch.Tensor:
        """f32[B]: drain-round source priority (-inf = not a source)."""
        util = torch.amax(utilization(agg, static), dim=1)
        return torch.where(static.alive, util, torch.tensor(-torch.inf, device=util.device))

    def drain_contrib(self, static: StaticCtx, gs, agg: Aggregates) -> torch.Tensor:
        """f32[P, R]: per-replica drain priority (higher drains first)."""
        p = torch.arange(static.part_load.shape[0], dtype=torch.int32,
                         device=static.part_load.device)
        lead = torch.sum(_leader_vec(static.part_load, p), dim=-1)
        foll = torch.sum(_follower_vec(static.part_load, p), dim=-1)
        r = agg.assignment.shape[1]
        is_leader = (torch.arange(r, device=lead.device) == 0)[None, :]
        return torch.where(is_leader, lead[:, None], foll[:, None])

    def dst_candidates(self, static, gs, agg, tables, cand_p, cand_s, cold):
        return cold

    def __repr__(self) -> str:
        return self.name


class UnportedGoal(Goal):
    """A goal the port names but cannot optimize yet (soft and kafka-assigner
    goals): it resolves in the registry, and the optimizer refuses it."""

    def __init__(self, name: str, is_hard: bool = False):
        self.name = name
        self.is_hard = is_hard
