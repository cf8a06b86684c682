"""Soft goals: distribution balancing and the potential outbound load guard.

  ReplicaDistributionGoal          cc/analyzer/goals/ReplicaDistributionGoal.java
  ResourceDistributionGoal x4      cc/analyzer/goals/ResourceDistributionGoal.java:53
  TopicReplicaDistributionGoal     cc/analyzer/goals/TopicReplicaDistributionGoal.java:53
  LeaderReplicaDistributionGoal    cc/analyzer/goals/LeaderReplicaDistributionGoal.java
  LeaderBytesInDistributionGoal    cc/analyzer/goals/LeaderBytesInDistributionGoal.java:39
  PotentialNwOutGoal               cc/analyzer/goals/PotentialNwOutGoal.java:40

Each derives its balance window from the current aggregates, flags brokers
outside it, and scores an action by the out-of-window distance it removes,
as the JAX package's goals/soft.py. Float sums go through `window_sum` (one
fixed, sequential order) and every `a * b + c` that XLA fuses goes through
`fma`, so the CPU and the card agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cruise_control_torch.analyzer.actions import KIND_MOVE, ActionBatch, slot_contrib
from cruise_control_torch.analyzer.goals.base import (
    SCORE_EPS,
    BulkCounts,
    Goal,
    balance_limits,
    distribution_score,
    imbalance,
)
from cruise_control_torch.common.resources import PartMetric, Resource
from cruise_control_torch.common.xla_math import fma
from cruise_control_torch.kernels.window_sum import window_sum


class WindowState(NamedTuple):
    lower: torch.Tensor  # f32[] balance window lower bound
    upper: torch.Tensor  # f32[]
    active: torch.Tensor  # bool[] goal participates (not a low-utilization cluster)


class TopicWindowState(NamedTuple):
    lower: torch.Tensor  # f32[T]
    upper: torch.Tensor  # f32[T]


class LeaderBytesInState(NamedTuple):
    lower: torch.Tensor  # f32[]
    upper: torch.Tensor  # f32[]
    active: torch.Tensor  # bool[]
    #: the bulk planner's move unit, the mean leader weight over the
    #: partitions (soft.py:516): static, so summed once per window rather
    #: than at every bulk wave
    unit: torch.Tensor  # f32[]


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return _scalar(-torch.inf, like)


def _zero(like: torch.Tensor) -> torch.Tensor:
    return _scalar(0.0, like)


def _n_alive(static) -> torch.Tensor:
    # a sum of 0/1 values: exact in any order
    return torch.clamp(torch.sum(static.alive.to(torch.float32)), min=1.0)


def _disk(static) -> torch.Tensor:
    return static.part_load[:, PartMetric.DISK]


def _leader_only(assignment, values_of_leader_slot, neg_inf):
    """f32[P, R]: the leader slot's value, -inf on the follower slots."""
    r = assignment.shape[1]
    is_leader = (torch.arange(r, device=assignment.device) == 0)[None, :]
    return torch.where(is_leader, values_of_leader_slot, neg_inf)


def _count_bulk(static, gs, counts: torch.Tensor, dst_ok: torch.Tensor) -> BulkCounts:
    """The count goals' bulk snapshot: dead brokers shed everything, the
    others their excess over the ceiling; deficit brokers rank first."""
    c = counts.to(torch.float32)
    zero = _zero(c)
    surplus = torch.where(static.dead, c, torch.maximum(zero, c - gs.upper))
    deficit = torch.maximum(zero, gs.lower - c)
    headroom = gs.upper - c
    dst_key = torch.where(dst_ok & (headroom > 0.0), fma(deficit, 1e3, headroom), _neg_inf(c))
    return BulkCounts(surplus=surplus, dst_key=dst_key)


class ResourceDistributionGoal(Goal):
    """Per-broker utilization of one resource within [avg*lo, avg*hi]."""

    is_hard = False
    uses_swaps = True

    def __init__(self, resource: Resource):
        self.resource = int(resource)
        self.name = {
            Resource.DISK: "DiskUsageDistributionGoal",
            Resource.NW_IN: "NetworkInboundUsageDistributionGoal",
            Resource.NW_OUT: "NetworkOutboundUsageDistributionGoal",
            Resource.CPU: "CpuUsageDistributionGoal",
        }[Resource(resource)]
        self.uses_leadership = resource in (Resource.CPU, Resource.NW_OUT)
        # K3 cases 8..11 (csrc/score_candidates.cu)
        self.kernel_id = 8 + self.resource

    def prepare(self, static, agg, dims):
        res = self.resource
        cap = static.broker_capacity[:, res]
        total_cap = window_sum(torch.where(static.alive, cap, _zero(cap)))
        avg = window_sum(agg.broker_load[:, res].contiguous()) / torch.clamp(total_cap, min=1e-9)
        lower, upper = balance_limits(avg, static.resource_balance_pct[res])
        active = avg >= static.low_utilization_threshold[res]
        return WindowState(lower=lower, upper=upper, active=active)

    def _cap(self, static):
        return torch.clamp(static.broker_capacity[:, self.resource], min=1e-9)

    def _util(self, static, agg):
        return agg.broker_load[:, self.resource] / self._cap(static)

    def broker_violation(self, static, gs, agg):
        u = self._util(static, agg)
        out = (u > gs.upper) | (u < gs.lower)
        return out & static.alive & gs.active

    def cost(self, static, gs, agg):
        dist = imbalance(self._util(static, agg), gs.lower, gs.upper)
        total = window_sum(torch.where(static.alive, dist, _zero(dist)))
        return torch.where(gs.active, total, _zero(total))

    def _endpoints(self, static, agg, act):
        res = self.resource
        src, dst = act.src.long(), act.dst.long()
        dres = act.dload[..., res]
        cap = self._cap(static)
        cap_src, cap_dst = cap[src], cap[dst]
        u_src = agg.broker_load[src, res] / cap_src
        u_dst = agg.broker_load[dst, res] / cap_dst
        return dres, u_src, u_dst, u_src - dres / cap_src, u_dst + dres / cap_dst

    def acceptance(self, static, gs, agg, act: ActionBatch):
        """Two-case acceptance (ResourceDistributionGoal.actionAcceptance
        :122-133): the window box where both endpoints sit on the right side
        of it, else the pairwise utilization gap must shrink."""
        dres, u_src, u_dst, u_src1, u_dst1 = self._endpoints(static, agg, act)
        dead = static.dead[act.src.long()]
        case1 = (u_src >= gs.lower) & (u_dst <= gs.upper)
        acc1 = (u_dst1 <= gs.upper) & ((u_src1 >= gs.lower) | dead)
        acc2 = torch.abs(u_src1 - u_dst1) < torch.abs(u_src - u_dst)
        ok = torch.where(case1, acc1, acc2 | dead)
        relevant = torch.abs(dres) > 0.0
        return ~gs.active | ~relevant | ok

    def action_score(self, static, gs, agg, act: ActionBatch):
        _, u_src, u_dst, u_src1, u_dst1 = self._endpoints(static, agg, act)
        score = distribution_score(u_src, u_dst, u_src1, u_dst1, gs.lower, gs.upper,
                                   tiebreak=u_src - u_dst)
        return torch.where(gs.active, score, _zero(score))

    def dst_preference(self, static, gs, agg):
        return -self._util(static, agg)

    def src_rank(self, static, gs, agg):
        u = self._util(static, agg)
        return torch.where(static.alive & gs.active, u, _neg_inf(u))

    def drain_contrib(self, static, gs, agg):
        return slot_contrib(static.part_load, agg.assignment, self.resource)

    def contribute_acceptance(self, static, gs, tables):
        cap = static.broker_capacity[:, self.resource]
        inf = _scalar(torch.inf, cap)
        hi = torch.where(gs.active, gs.upper * cap, inf)
        lo = torch.where(gs.active, gs.lower * cap, -inf)
        band_hi, band_lo, band_on = tables.band_hi.clone(), tables.band_lo.clone(), tables.band_on.clone()
        band_hi[:, self.resource] = torch.minimum(band_hi[:, self.resource], hi)
        band_lo[:, self.resource] = torch.maximum(band_lo[:, self.resource], lo)
        band_on[self.resource] = band_on[self.resource] | gs.active
        return tables._replace(band_hi=band_hi, band_lo=band_lo, band_on=band_on)


class ReplicaDistributionGoal(Goal):
    """Replica count per broker within the balance window around the mean
    (cc/analyzer/goals/ReplicaDistributionGoal.java)."""

    name = "ReplicaDistributionGoal"
    count_family = True
    kernel_id = 6

    def prepare(self, static, agg, dims):
        avg = torch.sum(agg.replica_count).to(torch.float32) / _n_alive(static)
        lower, upper = balance_limits(avg, static.replica_balance_pct)
        return WindowState(lower=torch.floor(lower), upper=torch.ceil(upper),
                           active=torch.tensor(True, device=avg.device))

    def broker_violation(self, static, gs, agg):
        c = agg.replica_count.to(torch.float32)
        return ((c > gs.upper) | (c < gs.lower)) & static.alive

    def cost(self, static, gs, agg):
        # integer-valued terms: exact in any order
        c = agg.replica_count.to(torch.float32)
        dist = imbalance(c, gs.lower, gs.upper)
        return torch.sum(torch.where(static.alive, dist, _zero(dist)))

    def acceptance(self, static, gs, agg, act: ActionBatch):
        src, dst = act.src.long(), act.dst.long()
        src_after = (agg.replica_count[src] - 1).to(torch.float32)
        dst_after = (agg.replica_count[dst] + 1).to(torch.float32)
        ok = ((src_after >= gs.lower) | static.dead[src]) & (dst_after <= gs.upper)
        return (act.kind != KIND_MOVE) | ok

    def action_score(self, static, gs, agg, act: ActionBatch):
        c_src = agg.replica_count[act.src.long()].to(torch.float32)
        c_dst = agg.replica_count[act.dst.long()].to(torch.float32)
        score = distribution_score(c_src, c_dst, c_src - 1.0, c_dst + 1.0, gs.lower, gs.upper,
                                   tiebreak=(c_src - c_dst) * 1e-2)
        return torch.where(act.kind == KIND_MOVE, score, _zero(score))

    def dst_preference(self, static, gs, agg):
        return -agg.replica_count.to(torch.float32)

    def src_rank(self, static, gs, agg):
        c = agg.replica_count.to(torch.float32)
        return torch.where(static.alive, c, _neg_inf(c))

    def drain_contrib(self, static, gs, agg):
        return (-_disk(static)[:, None]).expand(agg.assignment.shape)

    def bulk_counts(self, static, gs, agg):
        return _count_bulk(static, gs, agg.replica_count, static.replica_dst_ok)

    def contribute_acceptance(self, static, gs, tables):
        return tables._replace(hi_rep=torch.minimum(tables.hi_rep, gs.upper),
                               lo_rep=torch.maximum(tables.lo_rep, gs.lower))


class LeaderReplicaDistributionGoal(Goal):
    """Leader count per broker within the balance window
    (cc/analyzer/goals/LeaderReplicaDistributionGoal.java)."""

    name = "LeaderReplicaDistributionGoal"
    uses_leadership = True
    rotate_drain_candidates = True
    count_family = True
    kernel_id = 13

    def prepare(self, static, agg, dims):
        avg = torch.sum(agg.leader_count).to(torch.float32) / _n_alive(static)
        lower, upper = balance_limits(avg, static.leader_replica_balance_pct)
        return WindowState(lower=torch.floor(lower), upper=torch.ceil(upper),
                           active=torch.tensor(True, device=avg.device))

    def broker_violation(self, static, gs, agg):
        c = agg.leader_count.to(torch.float32)
        return ((c > gs.upper) | (c < gs.lower)) & static.alive

    def cost(self, static, gs, agg):
        c = agg.leader_count.to(torch.float32)
        dist = imbalance(c, gs.lower, gs.upper)
        return torch.sum(torch.where(static.alive, dist, _zero(dist)))

    def acceptance(self, static, gs, agg, act: ActionBatch):
        src, dst = act.src.long(), act.dst.long()
        src_after = (agg.leader_count[src] - 1).to(torch.float32)
        dst_after = (agg.leader_count[dst] + 1).to(torch.float32)
        ok = ((src_after >= gs.lower) | static.dead[src]) & (dst_after <= gs.upper)
        return ~(act.dleader > 0) | ok

    def action_score(self, static, gs, agg, act: ActionBatch):
        c_src = agg.leader_count[act.src.long()].to(torch.float32)
        c_dst = agg.leader_count[act.dst.long()].to(torch.float32)
        score = distribution_score(c_src, c_dst, c_src - 1.0, c_dst + 1.0, gs.lower, gs.upper,
                                   tiebreak=(c_src - c_dst) * 1e-2)
        return torch.where(act.dleader > 0, score, _zero(score))

    def dst_preference(self, static, gs, agg):
        return -agg.leader_count.to(torch.float32)

    def src_rank(self, static, gs, agg):
        c = agg.leader_count.to(torch.float32)
        return torch.where(static.alive, c, _neg_inf(c))

    def drain_contrib(self, static, gs, agg):
        # leader replicas only, the cheapest to move first
        w = fma(-1e-9, _disk(static), 1.0)
        return _leader_only(agg.assignment, w[:, None], _neg_inf(w))

    def bulk_counts(self, static, gs, agg):
        return _count_bulk(static, gs, agg.leader_count,
                           static.replica_dst_ok & static.leadership_dst_ok)

    def contribute_acceptance(self, static, gs, tables):
        return tables._replace(hi_lead=torch.minimum(tables.hi_lead, gs.upper),
                               lo_lead=torch.maximum(tables.lo_lead, gs.lower))


class TopicReplicaDistributionGoal(Goal):
    """Per-topic replicas spread evenly across brokers
    (cc/analyzer/goals/TopicReplicaDistributionGoal.java:53); drained by
    (topic, broker) surplus pairs, with a topic-swap fallback."""

    name = "TopicReplicaDistributionGoal"
    pair_drain = True
    count_family = True
    kernel_id = 12

    def prepare(self, static, agg, dims):
        per_topic = torch.sum(agg.topic_replica_count, dim=1).to(torch.float32)
        lower, upper = balance_limits(per_topic / _n_alive(static), static.topic_replica_balance_pct)
        return TopicWindowState(lower=torch.floor(lower), upper=torch.ceil(upper))

    def broker_violation(self, static, gs, agg):
        c = agg.topic_replica_count.to(torch.float32)
        out = (c > gs.upper[:, None]) | (c < gs.lower[:, None])
        return torch.any(out, dim=0) & static.alive

    def cost(self, static, gs, agg):
        c = agg.topic_replica_count.to(torch.float32)
        dist = imbalance(c, gs.lower[:, None], gs.upper[:, None])
        return torch.sum(torch.where(static.alive[None, :], dist, _zero(dist)))

    def _counts(self, static, agg, act):
        t = static.topic_id[act.p.long()].long()
        c_src = agg.topic_replica_count[t, act.src.long()]
        c_dst = agg.topic_replica_count[t, act.dst.long()]
        return t, c_src, c_dst

    def acceptance(self, static, gs, agg, act: ActionBatch):
        t, c_src, c_dst = self._counts(static, agg, act)
        src_after = (c_src - 1).to(torch.float32)
        dst_after = (c_dst + 1).to(torch.float32)
        ok = (((src_after >= gs.lower[t]) | static.dead[act.src.long()])
              & (dst_after <= gs.upper[t]))
        return (act.kind != KIND_MOVE) | ok

    def action_score(self, static, gs, agg, act: ActionBatch):
        t, c_src, c_dst = self._counts(static, agg, act)
        c_src, c_dst = c_src.to(torch.float32), c_dst.to(torch.float32)
        score = distribution_score(c_src, c_dst, c_src - 1.0, c_dst + 1.0, gs.lower[t],
                                   gs.upper[t], tiebreak=(c_src - c_dst) * 1e-2)
        return torch.where(act.kind == KIND_MOVE, score, _zero(score))

    def src_rank(self, static, gs, agg):
        c = agg.topic_replica_count.to(torch.float32)
        excess = torch.sum(torch.clamp(c - gs.upper[:, None], min=0.0), dim=0)
        return torch.where(static.alive & (excess > 0.0), excess, _neg_inf(excess))

    def drain_contrib(self, static, gs, agg):
        t = static.topic_id.long()
        b = torch.where(agg.assignment >= 0, agg.assignment, 0).long()
        cnt = agg.topic_replica_count[t[:, None], b].to(torch.float32)
        over = cnt - gs.upper[t][:, None]
        return torch.where(over > 0.0, fma(-1e-9, _disk(static)[:, None], over), _neg_inf(over))

    def contribute_acceptance(self, static, gs, tables):
        return tables._replace(hi_topic=torch.minimum(tables.hi_topic, gs.upper),
                               lo_topic=torch.maximum(tables.lo_topic, gs.lower))


class PotentialNwOutGoal(Goal):
    """Even if every replica on a broker became leader, its NW_OUT stays under
    the capacity threshold (cc/analyzer/goals/PotentialNwOutGoal.java:35-40)."""

    name = "PotentialNwOutGoal"
    kernel_id = 7

    def prepare(self, static, agg, dims):
        zero = _zero(static.capacity_limit)
        return WindowState(lower=zero, upper=zero.clone(),
                           active=torch.tensor(True, device=zero.device))

    def limit(self, static):
        return static.capacity_limit[:, Resource.NW_OUT]

    def broker_violation(self, static, gs, agg):
        return (agg.potential_nw_out > self.limit(static)) & static.alive

    def cost(self, static, gs, agg):
        excess = torch.clamp(agg.potential_nw_out - self.limit(static), min=0.0)
        return window_sum(torch.where(static.alive, excess, _zero(excess)))

    def acceptance(self, static, gs, agg, act: ActionBatch):
        after = agg.potential_nw_out[act.dst.long()] + act.dpnw
        return (act.dpnw <= 0.0) | (after <= self.limit(static)[act.dst.long()])

    def action_score(self, static, gs, agg, act: ActionBatch):
        src = act.src.long()
        src_over = agg.potential_nw_out[src] > self.limit(static)[src]
        return torch.where(src_over & (act.dpnw > SCORE_EPS), act.dpnw, _zero(act.dpnw))

    def dst_preference(self, static, gs, agg):
        return self.limit(static) - agg.potential_nw_out

    def src_rank(self, static, gs, agg):
        excess = agg.potential_nw_out - self.limit(static)
        return torch.where(static.alive & (excess > 0.0), excess, _neg_inf(excess))

    def drain_contrib(self, static, gs, agg):
        pnw = static.part_load[:, PartMetric.NW_OUT_LEADER]
        return pnw[:, None].expand(agg.assignment.shape)

    def contribute_acceptance(self, static, gs, tables):
        return tables._replace(hi_pnw=torch.minimum(tables.hi_pnw, self.limit(static)))


class LeaderBytesInDistributionGoal(Goal):
    """Leader bytes-in per broker under the window's ceiling
    (cc/analyzer/goals/LeaderBytesInDistributionGoal.java:39)."""

    name = "LeaderBytesInDistributionGoal"
    uses_leadership = True
    rotate_drain_candidates = True
    count_family = True
    leadership_swap = True
    kernel_id = 14

    def prepare(self, static, agg, dims):
        mean = window_sum(agg.leader_nw_in) / _n_alive(static)
        _, upper = balance_limits(mean, static.resource_balance_pct[Resource.NW_IN])
        mean_w = window_sum(static.part_load[:, PartMetric.NW_IN_LEADER].contiguous()) / torch.clamp(
            static.num_valid_partitions, min=1.0)
        # only the ceiling matters: the goal caps hot leaders
        return LeaderBytesInState(lower=_zero(upper), upper=upper,
                                  active=torch.tensor(True, device=upper.device),
                                  unit=torch.clamp(mean_w, min=1e-6))

    def broker_violation(self, static, gs, agg):
        return (agg.leader_nw_in > gs.upper) & static.alive

    def cost(self, static, gs, agg):
        excess = torch.clamp(agg.leader_nw_in - gs.upper, min=0.0)
        return window_sum(torch.where(static.alive, excess, _zero(excess)))

    def acceptance(self, static, gs, agg, act: ActionBatch):
        after = agg.leader_nw_in[act.dst.long()] + act.dleader_nw_in
        return ~(act.dleader_nw_in > 0.0) | (after <= gs.upper) | static.dead[act.src.long()]

    def action_score(self, static, gs, agg, act: ActionBatch):
        b_src = agg.leader_nw_in[act.src.long()]
        b_dst = agg.leader_nw_in[act.dst.long()]
        d = act.dleader_nw_in
        score = distribution_score(b_src, b_dst, b_src - d, b_dst + d, gs.lower, gs.upper,
                                   tiebreak=(b_src - b_dst) * 1e-6)
        return torch.where(d > 0.0, score, _zero(score))

    def dst_preference(self, static, gs, agg):
        return -agg.leader_nw_in

    def src_rank(self, static, gs, agg):
        over = agg.leader_nw_in > gs.upper
        return torch.where(static.alive & over, agg.leader_nw_in, _neg_inf(agg.leader_nw_in))

    def drain_contrib(self, static, gs, agg):
        nw_in = static.part_load[:, PartMetric.NW_IN_LEADER]
        return _leader_only(agg.assignment, nw_in[:, None], _neg_inf(nw_in))

    def bulk_counts(self, static, gs, agg):
        lnw = agg.leader_nw_in
        surplus = torch.where(static.dead, agg.leader_count.to(torch.float32),
                              torch.clamp(lnw - gs.upper, min=0.0) / gs.unit)
        headroom = gs.upper - lnw
        dst_key = torch.where(static.leadership_dst_ok & (headroom > 0.0), headroom,
                              _neg_inf(headroom))
        return BulkCounts(surplus=surplus, dst_key=dst_key)

    def contribute_acceptance(self, static, gs, tables):
        return tables._replace(hi_lnw=torch.minimum(tables.hi_lnw, gs.upper),
                               hi_lnw_waive_dead=torch.tensor(True, device=gs.upper.device))
