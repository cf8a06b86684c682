"""Bulk count planner: surplus/deficit waves for the count-family goals.

The counterpart of the JAX package's analyzer/bulk.py (make_bulk_count_round,
:76). Each surplus broker nominates its best cell per wave: a move of one of
its top-K drain candidates (K2) to the destination it is rank-paired with
(`rank_paired_destinations`, rotated by wave and round), or, for leadership
goals, a promotion of one of that candidate's followers. The cells are
scored exactly (K3) and a broker-, host- and partition-disjoint subset
applies at once (K4, one entry per broker: N = B, 2,600 on the smoke model).

The wave loop is a host loop, as in the reference's `while_loop`: it runs
while the last wave applied at least an eighth of the surplus set (the `go`
handoff, bulk.py:191), up to ceil(max surplus) waves, and the round is
skipped when no broker owes a whole unit (bulk.py:205-210). Each decision
reads one device value.
"""

from __future__ import annotations

import math

import torch

from cruise_control_torch.analyzer.actions import KIND_LEADERSHIP, KIND_MOVE
from cruise_control_torch.analyzer.context import (
    Aggregates,
    StaticCtx,
    apply_wave,
    make_touch_tag,
    rank_paired_destinations,
    replicas_on_dead,
)
from cruise_control_torch.kernels.broker_topk import broker_topk
from cruise_control_torch.kernels.score_candidates import ScoreContext, score_candidates


def make_bulk_count_round(goal, dims, k_cand: int, max_waves: int):
    """Build bulk_round(static, agg, tables, gs, contrib, rnd) -> (agg,
    applied) for a count-family goal; `agg` is updated in place and
    `applied` is a Python bool."""
    p_count, r = dims.num_partitions, dims.max_rf
    b_count = dims.num_brokers
    k = max(1, min(k_cand, p_count))
    use_leadership = goal.uses_leadership and r >= 2
    fam = r if use_leadership else 1

    def bulk_round(static: StaticCtx, agg: Aggregates, tables, gs, contrib, rnd: int = 0):
        dev = agg.assignment.device
        max_surplus = float(torch.max(goal.bulk_counts(static, gs, agg).surplus))
        if not max_surplus >= 1.0:
            return agg, False
        waves_dyn = min(max(math.ceil(max_surplus), 1), max_waves)
        neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
        contrib_r = torch.where(replicas_on_dead(static, agg.assignment),
                                torch.tensor(1e9, dtype=torch.float32, device=dev), contrib)
        cand_p, cand_s, cand_ok = broker_topk(contrib_r.contiguous(), agg.assignment,
                                              static.movable_partition, k, b_count)
        rows = torch.arange(b_count, dtype=torch.int64, device=dev)
        done = torch.zeros((b_count, k), dtype=torch.bool, device=dev)
        kind_move = torch.tensor(KIND_MOVE, dtype=torch.int32, device=dev)
        kind_lead = torch.tensor(KIND_LEADERSHIP, dtype=torch.int32, device=dev)
        slots = torch.arange(1, r, dtype=torch.int32, device=dev)[None, None, :]
        ctx = ScoreContext(static, agg, tables, goal, gs)
        applied = False
        for w in range(waves_dyn):
            counts = goal.bulk_counts(static, gs, agg)
            valid_src = counts.surplus > 0.0
            n_valid = torch.sum(valid_src.to(torch.int32))
            paired = rank_paired_destinations(valid_src, counts.dst_key, w + rnd)
            a = agg.assignment
            live = cand_ok & ~done & valid_src[:, None]
            s_mv = score_candidates(static, agg, tables, goal, gs, cand_p, kind_move, cand_s,
                                    paired[:, None], ctx=ctx)
            s_mv = torch.where(live, s_mv, neg_inf)
            if use_leadership:
                p3 = cand_p[:, :, None]
                s_ld = score_candidates(static, agg, tables, goal, gs, p3, kind_lead, slots,
                                        a[p3.long(), slots.long()], ctx=ctx)
                s_ld = torch.where(live[:, :, None], s_ld, neg_inf)
                cells = torch.cat([s_mv[:, :, None], s_ld], dim=2).reshape(b_count, k * fam)
            else:
                cells = s_mv
            j = torch.argmax(cells, dim=1)
            best = cells[rows, j]
            k_i, f_i = j // fam, j % fam
            p_i = cand_p[rows, k_i]
            s_i = torch.where(f_i == 0, cand_s[rows, k_i], f_i.to(torch.int32))
            kind_i = torch.where(f_i == 0, kind_move, kind_lead)
            dst_i = torch.where(f_i == 0, paired, a[p_i.long(), torch.clamp(f_i, min=0)])
            sel = apply_wave(static, agg, p_i.contiguous(), kind_i.contiguous(),
                             s_i.contiguous(), dst_i.contiguous(), best.contiguous(),
                             torch.isfinite(best), make_touch_tag(rnd, w))
            done[rows, k_i] |= sel
            n_applied = torch.sum(sel.to(torch.int32))
            # one device read per wave: keep going only while waves deliver
            # bulk-scale progress (at least 1/8 of the surplus set)
            n_applied, n_valid = (int(x) for x in torch.stack([n_applied, n_valid]).cpu())
            applied = applied or n_applied > 0
            if n_applied < max(1, n_valid // 8):
                break
        return agg, applied

    return bulk_round
