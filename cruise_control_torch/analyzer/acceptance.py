"""Shared acceptance tables: the whole prior-goal chain as one check.

Each optimized goal contributes its box constraints into `AcceptanceTables`
(elementwise min of uppers / max of lowers), and `tables_acceptance` checks
any candidate batch against the merged tables; see the JAX package's module
of the same name for the constraint catalogue. `score_batch` here is the
plain composition; kernel K3 (kernels.score_candidates) computes the same
scores in one CUDA kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from cruise_control_torch.analyzer.actions import DEAD_EVACUATION_BONUS, KIND_MOVE, ActionBatch
from cruise_control_torch.analyzer.context import Aggregates, StaticCtx, dst_hosts_partition
from cruise_control_torch.analyzer.goals.base import SCORE_EPS
from cruise_control_torch.common.resources import Resource


class AcceptanceTables(NamedTuple):
    """Merged constraints of all previously-optimized goals (raw aggregate
    units; +/-inf disables)."""

    hi_load: torch.Tensor  # f32[B, 4] hard upper (capacity goals)
    lo_load: torch.Tensor  # f32[B, 4] hard lower
    band_hi: torch.Tensor  # f32[B, 4] distribution band upper
    band_lo: torch.Tensor  # f32[B, 4] distribution band lower
    band_on: torch.Tensor  # bool[4]
    hi_rep: torch.Tensor  # f32[B]
    lo_rep: torch.Tensor  # f32[B]
    hi_lead: torch.Tensor  # f32[B]
    lo_lead: torch.Tensor  # f32[B]
    hi_pnw: torch.Tensor  # f32[B]
    hi_lnw: torch.Tensor  # f32[B]
    hi_lnw_waive_dead: torch.Tensor  # bool[]
    hi_topic: torch.Tensor  # f32[T]
    lo_topic: torch.Tensor  # f32[T]
    hi_host_cpu: torch.Tensor  # f32[H]
    rack_enabled: torch.Tensor  # bool[]


def empty_tables(dims, device) -> AcceptanceTables:
    b, t, h = dims.num_brokers, dims.num_topics, dims.num_hosts

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return AcceptanceTables(
        hi_load=full((b, 4), torch.inf),
        lo_load=full((b, 4), -torch.inf),
        band_hi=full((b, 4), torch.inf),
        band_lo=full((b, 4), -torch.inf),
        band_on=torch.zeros(4, dtype=torch.bool, device=device),
        hi_rep=full((b,), torch.inf),
        lo_rep=full((b,), -torch.inf),
        hi_lead=full((b,), torch.inf),
        lo_lead=full((b,), -torch.inf),
        hi_pnw=full((b,), torch.inf),
        hi_lnw=full((b,), torch.inf),
        hi_lnw_waive_dead=torch.tensor(False, device=device),
        hi_topic=full((t,), torch.inf),
        lo_topic=full((t,), -torch.inf),
        hi_host_cpu=full((h,), torch.inf),
        rack_enabled=torch.tensor(False, device=device),
    )


def band_move_acceptance(tables: AcceptanceTables, agg: Aggregates, src, dst, dload,
                         dead_src) -> torch.Tensor:
    """bool[...]: the two-case distribution-band check for a (possibly
    signed) per-resource load transfer src -> dst
    (ResourceDistributionGoal.actionAcceptance :91-133)."""
    src, dst = src.long(), dst.long()
    s = agg.broker_load[src]
    d = agg.broker_load[dst]
    lo_s, hi_s = tables.band_lo[src], tables.band_hi[src]
    lo_d, hi_d = tables.band_lo[dst], tables.band_hi[dst]
    dead = dead_src[..., None]
    pos = dload >= 0.0
    case1 = torch.where(pos, (s >= lo_s) & (d <= hi_d), (d >= lo_d) & (s <= hi_s))
    acc1_pos = (d + dload <= hi_d) & ((s - dload >= lo_s) | dead)
    acc1_neg = (s - dload <= hi_s) & (d + dload >= lo_d)
    acc1 = torch.where(pos, acc1_pos, acc1_neg)
    prev = s - d
    acc2 = torch.abs(prev - 2.0 * dload) < torch.abs(prev)
    ok = torch.where(case1, acc1, acc2 | dead)
    ok = ok | (dload == 0.0) | ~tables.band_on
    return torch.all(ok, dim=-1)


def build_tables(priors: Sequence, static: StaticCtx, agg: Aggregates, dims) -> AcceptanceTables:
    """Merge the given goals' bounds from the current aggregates in one shot
    (the optimizer accumulates the same tables goal by goal)."""
    tables = empty_tables(dims, agg.assignment.device)
    for g in priors:
        gs = g.prepare(static, agg, dims)
        tables = g.contribute_acceptance(static, gs, tables)
    return tables


def tables_acceptance(static: StaticCtx, tables: AcceptanceTables, agg: Aggregates,
                      act: ActionBatch) -> torch.Tensor:
    """bool[...]: does the action satisfy every merged bound? Values come
    from the current aggregates, bounds from the round's tables."""
    src, dst = act.src.long(), act.dst.long()
    dead_src = static.dead[src]
    d = act.dload
    load_dst_after = agg.broker_load[dst] + d
    load_src_after = agg.broker_load[src] - d
    inc = d > 0.0
    ok = torch.all(~inc | (load_dst_after <= tables.hi_load[dst]), dim=-1)
    ok = ok & (dead_src | torch.all(~inc | (load_src_after >= tables.lo_load[src]), dim=-1))
    ok = ok & band_move_acceptance(tables, agg, src, dst, d, dead_src)

    drep = act.drep.to(torch.float32)
    rep_inc = drep > 0
    ok = ok & (~rep_inc | (agg.replica_count[dst] + drep <= tables.hi_rep[dst]))
    ok = ok & (~rep_inc | dead_src | (agg.replica_count[src] - drep >= tables.lo_rep[src]))

    dlead = act.dleader.to(torch.float32)
    lead_inc = dlead > 0
    ok = ok & (~lead_inc | (agg.leader_count[dst] + dlead <= tables.hi_lead[dst]))
    ok = ok & (~lead_inc | dead_src | (agg.leader_count[src] - dlead >= tables.lo_lead[src]))

    pnw_inc = act.dpnw > 0.0
    ok = ok & (~pnw_inc | (agg.potential_nw_out[dst] + act.dpnw <= tables.hi_pnw[dst]))

    lnw_inc = act.dleader_nw_in > 0.0
    lnw_ok = agg.leader_nw_in[dst] + act.dleader_nw_in <= tables.hi_lnw[dst]
    ok = ok & (~lnw_inc | lnw_ok | (tables.hi_lnw_waive_dead & dead_src))

    topic = static.topic_id[act.p.long()].long()
    ok = ok & (~rep_inc | (agg.topic_replica_count[topic, dst] + act.drep <= tables.hi_topic[topic]))
    ok = ok & (~rep_inc | dead_src
               | (agg.topic_replica_count[topic, src] - act.drep >= tables.lo_topic[topic]))

    dcpu = d[..., Resource.CPU]
    host_src = static.broker_host[src]
    host_dst = static.broker_host[dst].long()
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    host_after = agg.host_cpu_load[host_dst] + torch.where(host_src == host_dst.to(host_src.dtype),
                                                           zero, dcpu)
    ok = ok & ((dcpu <= 0.0) | (host_after <= tables.hi_host_cpu[host_dst]))

    rack_src = static.broker_rack[src]
    rack_dst = static.broker_rack[dst]
    count_dst = agg.rack_replica_count[act.p.long(), rack_dst.long()] - (rack_src == rack_dst).to(torch.int32)
    ok = ok & (~(tables.rack_enabled & rep_inc) | (count_dst == 0))
    return ok


def structural_mask(static: StaticCtx, agg: Aggregates, act: ActionBatch) -> torch.Tensor:
    """Checks every action must pass regardless of goals (GoalUtils.legitMove
    + OptimizationOptions filtering; the port takes the default options, so
    the reference's only_move_immigrants term is always true)."""
    is_move = act.kind == KIND_MOVE
    dst = act.dst.long()
    ok = act.valid & static.movable_partition[act.p.long()]
    ok = ok & torch.where(is_move, static.replica_dst_ok[dst], static.leadership_dst_ok[dst])
    ok = ok & ~(is_move & dst_hosts_partition(agg, act.p, act.dst))
    return ok


def score_batch(static: StaticCtx, agg: Aggregates, act: ActionBatch, goal, gs, tables):
    """f32[...]: masked score of each candidate (-inf where unacceptable),
    with the dead-source evacuation bonus."""
    mask = structural_mask(static, agg, act)
    mask = mask & tables_acceptance(static, tables, agg, act)
    mask = mask & goal.acceptance(static, gs, agg, act)
    score = goal.action_score(static, gs, agg, act)
    evac = static.dead[act.src.long()] & ((act.kind == KIND_MOVE) | (act.dleader > 0))
    zero = torch.zeros((), dtype=torch.float32, device=score.device)
    score = score + torch.where(evac, torch.tensor(DEAD_EVACUATION_BONUS, dtype=torch.float32,
                                                   device=score.device), zero)
    return torch.where(mask & (score > SCORE_EPS), score,
                       torch.tensor(-torch.inf, device=score.device))
