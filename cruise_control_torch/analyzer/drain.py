"""Drain/fill round: the batched-mode engine for every goal.

Per round, the top-V source brokers each nominate their top-K drain
candidates (K2) toward C goal-chosen destinations; the [V, K, C] grid (and,
for goals that shift load through leadership, the [P, R-1] promotion grid) is
scored exactly (K3), and `apply_waves` conflict-free waves apply a
broker-disjoint subset each (K4). The round itself is PyTorch glue between
the kernels, as the JAX package's make_drain_round (drain.py:883) is XLA
glue between its fused ops.

Top-k selections here break ties by the lowest index explicitly (a stable
descending sort), the order `lax.top_k` gives: `torch.topk` promises none.
"""

from __future__ import annotations

import torch

from cruise_control_torch.analyzer.actions import KIND_LEADERSHIP, KIND_MOVE, leadership_grid
from cruise_control_torch.analyzer.context import (
    Aggregates,
    StaticCtx,
    apply_wave,
    make_touch_tag,
    replicas_on_dead,
)
from cruise_control_torch.kernels.broker_topk import broker_topk
from cruise_control_torch.kernels.score_candidates import score_candidates


def top_k(values: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, ties to the
    lowest index (lax.top_k's order)."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:k], idx[:k]


def heavy_picks(static, agg, contrib, brokers: torch.Tensor, k: int, num_brokers: int):
    """(p, slot, valid) [V, k]: top-k drain candidates of the given brokers
    (K2 broker_topk, the JAX package's broker_top_replicas)."""
    p, s, ok = broker_topk(contrib, agg.assignment, static.movable_partition, k, num_brokers)
    b = brokers.long()
    return p[b], s[b], ok[b]


def table_demoted_pref(static: StaticCtx, gs, agg: Aggregates, goal, tables):
    """f32[B]: the goal's destination preference, -inf for ineligible brokers,
    with table-infeasible brokers demoted below every feasible one."""
    pref = goal.dst_preference(static, gs, agg)
    neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=pref.device)
    pref = torch.where(static.replica_dst_ok, pref, neg_inf)
    if tables is not None:
        headroom = (
            torch.all(agg.broker_load < tables.hi_load, dim=1)
            & (agg.replica_count < tables.hi_rep)
            & (agg.potential_nw_out < tables.hi_pnw)
            & (agg.leader_nw_in < tables.hi_lnw)
        )
        span = 1.0 + torch.amax(torch.abs(torch.where(torch.isfinite(pref), pref, 0.0)))
        pref = torch.where(headroom, pref, pref - 2.0 * span)
    return pref


def rack_diverse_cold(static: StaticCtx, gs, agg: Aggregates, goal, tables, dims,
                      c: int) -> torch.Tensor:
    """i32[C]: the best eligible broker of each non-empty rack first, then the
    globally best-preferred brokers (one combined top-k)."""
    pref = table_demoted_pref(static, gs, agg, goal, tables)
    nr = dims.num_racks
    dev = pref.device
    neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
    rack_mask = static.broker_rack[None, :] == torch.arange(nr, device=dev)[:, None]
    per_rack = torch.where(rack_mask, pref[None, :], neg_inf)
    best_broker = torch.argmax(per_rack, dim=1).to(torch.int32)
    best_val = torch.amax(per_rack, dim=1)
    span = 2.0 + torch.amax(torch.abs(torch.where(torch.isfinite(pref), pref, 0.0)))
    combined = torch.cat(
        [torch.where(torch.isfinite(best_val), best_val + 2.0 * span, neg_inf), pref])
    _, idx = top_k(combined, min(c, nr + pref.shape[0]))
    idx = idx.to(torch.int32)
    return torch.where(idx < nr, best_broker[torch.clamp(idx, max=nr - 1).long()], idx - nr)


def make_drain_round(goal, dims, n_src: int, k_rep: int, c_dst: int, apply_waves: int):
    """Build drain_round(static, agg, tables, gs, contrib, rnd) -> (agg, applied),
    where `applied` is a bool device tensor. `agg` is updated in place."""
    p_count, r = dims.num_partitions, dims.max_rf
    v = max(1, min(n_src, dims.num_brokers))
    k = max(1, min(k_rep, p_count))
    c = max(1, min(c_dst, dims.num_brokers))
    use_leadership = goal.uses_leadership and r >= 2
    j_lead = max(1, min(n_src, p_count * (r - 1))) if use_leadership else 0
    waves = max(1, apply_waves)

    def drain_round(static: StaticCtx, agg: Aggregates, tables, gs, contrib, rnd: int = -1):
        dev = agg.assignment.device
        neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
        rank = goal.src_rank(static, gs, agg)
        rank = torch.where(static.dead, torch.tensor(torch.inf, device=dev), rank)
        _, hot = top_k(rank, v)
        hot_ok = torch.isfinite(rank[hot]) | static.dead[hot]

        # every replica on a dead broker is a drain candidate whatever the
        # goal's own priorities (evacuation precedes balance)
        contrib = torch.where(replicas_on_dead(static, agg.assignment),
                              torch.tensor(1e9, dtype=torch.float32, device=dev), contrib)
        cand_p, cand_s, cand_ok = heavy_picks(static, agg, contrib.contiguous(), hot, k,
                                              dims.num_brokers)
        cand_ok = cand_ok & hot_ok[:, None]

        cold = rack_diverse_cold(static, gs, agg, goal, tables, dims, c)
        dsts_g = goal.dst_candidates(static, gs, agg, tables, cand_p, cand_s, cold)
        dst_lazy = (dsts_g[None, None, :] if dsts_g.dim() == 1 else dsts_g).to(torch.int32)
        dsts = dst_lazy.expand(v, k, c)
        kind_move = torch.tensor(KIND_MOVE, dtype=torch.int32, device=dev)
        s_mv = score_candidates(static, agg, tables, goal, gs, cand_p[:, :, None], kind_move,
                                cand_s[:, :, None], dst_lazy)
        cells = torch.where(cand_ok[:, :, None], s_mv, neg_inf).expand(v, k, c).reshape(v, k * c)

        if use_leadership:
            lp, lkind, lslot, ldst = leadership_grid(agg.assignment)
            sl = score_candidates(static, agg, tables, goal, gs, lp, lkind, lslot, ldst)
            lead_s0, lead_i = top_k(sl.reshape(p_count * (r - 1)), j_lead)
            lead_p = (lead_i // (r - 1)).to(torch.int32)
            lead_slot = (lead_i % (r - 1)).to(torch.int32) + 1
            lead_kind = torch.full((j_lead,), KIND_LEADERSHIP, dtype=torch.int32, device=dev)
            lead_done = torch.zeros(j_lead, dtype=torch.bool, device=dev)

        rows0 = torch.arange(v, dtype=torch.int64, device=dev)
        blocked = torch.zeros((v, k * c), dtype=torch.bool, device=dev)
        applied_any = torch.zeros((), dtype=torch.bool, device=dev)
        move_kind = torch.full((v,), KIND_MOVE, dtype=torch.int32, device=dev)
        for w in range(waves):
            masked = torch.where(blocked, neg_inf, cells)
            if w == waves - 1:
                ci = torch.argmax(masked, dim=1)
                bs = masked[rows0, ci]
            else:
                # per row: argmax over the K candidates of ONE rotated
                # destination column (the sorted-by-sorted matching that keeps
                # the whole source set moving in parallel)
                c_i = (rows0 + w) % c
                col = masked.reshape(v, k, c)[rows0, :, c_i]
                j = torch.argmax(col, dim=1)
                ci = j * c + c_i
                bs = col[rows0, j]
            k_i = ci // c
            mp = cand_p[rows0, k_i]
            ms = cand_s[rows0, k_i]
            md = dsts[rows0, k_i, ci % c]
            s_now = score_candidates(static, agg, tables, goal, gs, mp, move_kind, ms, md)
            all_ok = torch.isfinite(bs) & torch.isfinite(s_now)
            if use_leadership:
                # every not-yet-applied promotion re-bids each wave, toward
                # wherever its follower lives now
                l_dst = agg.assignment[lead_p.long(), lead_slot.long()]
                ls_now = score_candidates(static, agg, tables, goal, gs, lead_p, lead_kind,
                                          lead_slot, l_dst)
                lok = torch.isfinite(lead_s0) & torch.isfinite(ls_now) & ~lead_done
                e_p = torch.cat([mp, lead_p])
                e_kind = torch.cat([move_kind, lead_kind])
                e_slot = torch.cat([ms, lead_slot])
                e_dst = torch.cat([md, l_dst])
                e_score = torch.cat([s_now, ls_now])
                e_ok = torch.cat([all_ok, lok])
            else:
                e_p, e_kind, e_slot, e_dst, e_score, e_ok = mp, move_kind, ms, md, s_now, all_ok
            sel = apply_wave(static, agg, e_p.contiguous(), e_kind.contiguous(),
                             e_slot.contiguous(), e_dst.contiguous(), e_score.contiguous(),
                             e_ok.contiguous(), make_touch_tag(rnd, w))
            sel_mv = sel[:v]
            # a nomination that failed re-scoring is a dead cell; an applied
            # move's replica left its source, so all its destination cells die
            dead = sel_mv | (torch.isfinite(bs) & ~torch.isfinite(s_now))
            blocked[rows0, ci] |= dead
            cell_ids = (k_i * c)[:, None] + torch.arange(c, device=dev)[None, :]
            blocked[rows0[:, None], cell_ids] |= sel_mv[:, None]
            if use_leadership:
                lead_done = lead_done | sel[v:]
            applied_any = applied_any | torch.any(sel)
        return agg, applied_any

    return drain_round
