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
  bulk_counts       the bulk count planner's surplus and destination key
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from cruise_control_torch.analyzer.actions import (
    ActionBatch,
    _follower_vec,
    _leader_vec,
    load_total,
)
from cruise_control_torch.analyzer.context import Aggregates, StaticCtx, utilization
from cruise_control_torch.common.xla_math import fma, xla_tanh

#: Margin factor applied inside balance thresholds (BALANCE_MARGIN = 0.9).
BALANCE_MARGIN = 0.9

#: Minimum action score considered a real improvement (float32 noise floor).
SCORE_EPS = 1e-6


class BulkCounts(NamedTuple):
    """Per-broker surplus (in move units; a dead broker's whole holding) and
    destination key (higher = better, -inf = ineligible) for the bulk count
    planner (analyzer.bulk)."""

    surplus: torch.Tensor  # f32[B]
    dst_key: torch.Tensor  # f32[B]


class Goal:
    name: str = ""
    is_hard: bool = False
    #: nominate replica moves in the batch_k=1 grid (every goal of the
    #: default stack does)
    uses_moves: bool = True
    #: also nominate promotions from the [P, R-1] leadership grid each round
    uses_leadership: bool = False
    #: floor/ceil count goal, drained by the bulk planner when it is on
    #: (pair-drain goals excepted: their pair rounds are that planner)
    count_family: bool = False
    #: run the replica-swap round when moves stall (needs `resource`)
    uses_swaps: bool = False
    #: drain (topic, broker) surplus pairs instead of brokers, with a
    #: topic-swap fallback (TopicReplicaDistributionGoal)
    pair_drain: bool = False
    #: leadership-relay fallback when promotions stall (LeaderBytesIn)
    leadership_swap: bool = False
    #: walk the drain ranking with a round-seeded jitter, and stall only
    #: after 8 empty rounds
    rotate_drain_candidates: bool = False
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
        lead = load_total(_leader_vec(static.part_load, p))
        foll = load_total(_follower_vec(static.part_load, p))
        r = agg.assignment.shape[1]
        is_leader = (torch.arange(r, device=lead.device) == 0)[None, :]
        return torch.where(is_leader, lead[:, None], foll[:, None])

    def dst_candidates(self, static, gs, agg, tables, cand_p, cand_s, cold):
        return cold

    def bulk_counts(self, static: StaticCtx, gs, agg: Aggregates) -> BulkCounts:
        raise NotImplementedError

    def __repr__(self) -> str:
        return self.name


def imbalance(value, lower, upper):
    """Distance outside [lower, upper]; 0 inside."""
    zero = torch.zeros((), dtype=torch.float32, device=value.device)
    return torch.maximum(zero, value - upper) + torch.maximum(zero, lower - value)


def balance_limits(avg, balance_pct):
    """(lower, upper) around avg, the margin tightened by BALANCE_MARGIN."""
    margin = (balance_pct - 1.0) * BALANCE_MARGIN
    upper = avg * (1.0 + margin)
    lower = avg * torch.clamp(1.0 - margin, min=0.0)
    return lower, upper


def distribution_score(before_src, before_dst, after_src, after_dst, lower, upper, tiebreak):
    """The imbalance the action removes on its two brokers plus a bounded
    tiebreak, where it removes some and neither broker gets worse; else 0.
    `red + 1e-3 * tanh(tiebreak)` is one fused multiply-add in XLA."""
    i_src0 = imbalance(before_src, lower, upper)
    i_dst0 = imbalance(before_dst, lower, upper)
    i_src1 = imbalance(after_src, lower, upper)
    i_dst1 = imbalance(after_dst, lower, upper)
    red = i_src0 + i_dst0 - i_src1 - i_dst1
    endpoint_ok = (i_src1 <= i_src0 + SCORE_EPS) & (i_dst1 <= i_dst0 + SCORE_EPS)
    score = fma(1e-3, xla_tanh(tiebreak), red)
    return torch.where((red > SCORE_EPS) & endpoint_ok, score, torch.zeros_like(score))


class UnportedGoal(Goal):
    """A goal the port names but cannot optimize yet (the kafka-assigner
    goals): it resolves in the registry, and the optimizer refuses it."""

    def __init__(self, name: str, is_hard: bool = False):
        self.name = name
        self.is_hard = is_hard
