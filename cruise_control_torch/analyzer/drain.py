"""Drain/fill rounds: the batched-mode engines.

`make_drain_round`: per round, the top-V source brokers each nominate their
top-K drain candidates (K2) toward C goal-chosen destinations; the [V, K, C]
grid (and, for goals that shift load through leadership, the [P, R-1]
promotion grid) is scored exactly (K3), and `apply_waves` conflict-free
waves apply a broker-disjoint subset each (K4).

TopicReplicaDistributionGoal drains (topic, broker) surplus pairs instead
(`make_pair_drain_round`, its replicas picked by K6), with a topic-swap
fallback (`make_topic_swap_round`); LeaderBytesInDistributionGoal falls back
to leadership relays (`make_leadership_relay_round`). The swaps and relays
are validated by K5 and applied two legs at a time by K4.

The rounds are PyTorch glue between the kernels, as the JAX package's
drain.py is XLA glue between its fused ops. Top-k selections break ties by
the lowest index explicitly (a stable descending sort), the order
`lax.top_k` gives: `torch.topk` promises none. Every `a * b + c` that XLA
fuses goes through `fma`.
"""

from __future__ import annotations

import torch

from cruise_control_torch.analyzer.actions import (
    KIND_LEADERSHIP,
    KIND_MOVE,
    _follower_vec,
    _leader_vec,
    build_selected,
    leadership_grid,
    load_total,
)
from cruise_control_torch.analyzer.context import (
    Aggregates,
    StaticCtx,
    apply_wave,
    make_touch_tag,
    replicas_on_dead,
)
from cruise_control_torch.analyzer.goals.base import imbalance
from cruise_control_torch.common.resources import PartMetric
from cruise_control_torch.common.xla_math import fma
from cruise_control_torch.kernels.broker_topk import broker_topk
from cruise_control_torch.kernels.pair_picks import pair_picks
from cruise_control_torch.kernels.score_candidates import score_candidates
from cruise_control_torch.kernels.score_swaps import LEADERSHIP_RELAY, TOPIC_SWAP, score_swaps
from cruise_control_torch.kernels.window_sum import window_sum


def top_k(values: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, ties
    to the lowest index (lax.top_k's order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def round_jitter(n: int, rnd: int, device) -> torch.Tensor:
    """f32[n] in [0.5, 1): the round-seeded multiplicative jitter of the
    rotated candidate rankings (drain.py:59): uint32 hashing, done in int64
    and masked to 32 bits."""
    mask = 0xFFFFFFFF
    mult = 2654435761
    x = (torch.arange(n, dtype=torch.int64, device=device) + (int(rnd) * 40503 & mask)) & mask
    # x * mult mod 2**32, split so that no product leaves int64
    lo, hi = x & 0xFFFF, x >> 16
    h = (lo * mult + ((hi * mult) & 0xFFFF) * 65536) & mask
    return 0.5 + 0.5 * (h >> 8).to(torch.float32) / float(1 << 24)


def heavy_picks(static, agg, contrib, brokers: torch.Tensor, k: int, num_brokers: int):
    """(p, slot, valid) [V, k]: top-k drain candidates of the given brokers
    (K2 broker_topk, the JAX package's broker_top_replicas)."""
    p, s, ok = broker_topk(contrib, agg.assignment, static.movable_partition, k, num_brokers)
    b = brokers.long()
    return p[b], s[b], ok[b]


def light_picks(static, agg, contrib, brokers: torch.Tensor, k: int, num_brokers: int):
    """(p, slot, valid) [V, k]: the k lightest candidates of the given brokers."""
    p, s, ok = broker_topk(contrib, agg.assignment, static.movable_partition, k, num_brokers,
                           heaviest=False)
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


# -- TopicReplicaDistributionGoal: (topic, broker) surplus pairs -------------------


def _mean_replica_load(agg: Aggregates) -> torch.Tensor:
    """f32[4]: the mean per-replica load (drain.py:214, :278)."""
    n = torch.clamp(torch.sum(agg.replica_count).to(torch.float32), min=1.0)
    return window_sum(agg.broker_load) / n


def _wrap_i32(x):
    """x wrapped to int32 as two's complement (int32 arithmetic in JAX wraps)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def select_surplus_pairs(static: StaticCtx, agg: Aggregates, tables, gs, rnd: int, v: int,
                         t_count: int, b_count: int):
    """(pair_t, pair_b, pair_ok), each [V]: one (topic, broker) surplus pair
    per source broker, its worst over-topic, for the top-V brokers
    (drain.py:183). Dead brokers' groups rank first; ties rotate with the
    round; brokers that can shed an average replica without breaking a
    contributed lower bound rank above band-frozen ones."""
    dev = agg.assignment.device
    neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
    trc = agg.topic_replica_count
    excess = trc.to(torch.float32) - gs.upper[:, None]
    excess = torch.where(static.alive[None, :], excess,
                         torch.where(trc > 0, torch.tensor(1e9, device=dev), neg_inf))
    t_ids = torch.arange(t_count, dtype=torch.int64, device=dev)
    # the rotations are int32 arithmetic in the reference: from round ~79 on
    # (b + rnd * 104729) * 257 wraps, and the wrapped value decides the order
    rot_t = (_wrap_i32(_wrap_i32(t_ids + _wrap_i32(rnd * 7919)) * 131) % 104729).to(
        torch.float32) / 104729.0
    key_tb = torch.where(torch.isfinite(excess), fma(1e-3, rot_t[:, None], excess), neg_inf)
    best_t = torch.argmax(key_tb, dim=0)
    b_ids = torch.arange(b_count, dtype=torch.int64, device=dev)
    best_val = excess[best_t, b_ids]
    rot_b = (_wrap_i32(_wrap_i32(b_ids + _wrap_i32(rnd * 104729)) * 257) % 7919).to(
        torch.float32) / 7919.0
    typ = _mean_replica_load(agg)
    lo_margin = agg.broker_load - tables.band_lo
    mobile = torch.all(~tables.band_on[None, :] | (lo_margin >= 0.5 * typ[None, :]), dim=1)
    mobile = mobile & (agg.replica_count.to(torch.float32) - 1.0 >= tables.lo_rep)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    boost = best_val + torch.where(mobile, torch.tensor(1e3, device=dev), zero)
    brk_key = torch.where(torch.isfinite(best_val) & (best_val > 0.0),
                          fma(1e-3, rot_b, boost), neg_inf)
    _, hot_b = top_k(brk_key, v)
    pair_t = best_t[hot_b]
    vals = excess[pair_t, hot_b]
    return (pair_t.to(torch.int32), hot_b.to(torch.int32),
            torch.isfinite(vals) & (vals > 0.0))


def pair_replica_picks(static: StaticCtx, agg: Aggregates, pair_t, pair_b, k: int,
                       b_count: int):
    """(cand_p, cand_s, found) [V, k]: the first k movable replicas of each
    (topic, broker) pair (K6, drain.py:235)."""
    return pair_picks(agg.assignment, static.topic_id, static.movable_partition, pair_t, pair_b,
                      k, b_count)


def topic_dst_list(static: StaticCtx, agg: Aggregates, tables, gs, pair_t, pair_b, rnd: int,
                   c_dst: int, b_count: int) -> torch.Tensor:
    """i32[V, C]: per pair, destinations under the pair's topic ceiling,
    band-roomy ones first, with a round-rotated per-row ramp breaking near
    ties (drain.py:264)."""
    dev = agg.assignment.device
    cnt_rows = agg.topic_replica_count[pair_t.long()].to(torch.float32)
    topic_ok = static.replica_dst_ok[None, :] & (cnt_rows + 1.0 <= gs.upper[pair_t.long()][:, None])
    typ = _mean_replica_load(agg)
    band_room = torch.all(~tables.band_on[None, :]
                          | (agg.broker_load + 0.5 * typ[None, :] <= tables.band_hi), dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    room = torch.where(band_room, torch.tensor(1e3, device=dev), zero)
    d_pref = torch.where(topic_ok, -cnt_rows + room[None, :],
                         torch.tensor(-torch.inf, device=dev))
    n_valid = torch.clamp(torch.sum(static.broker_valid.to(torch.int64)), min=1)
    b_all = torch.arange(b_count, dtype=torch.int64, device=dev)
    jit_d = ((b_all[None, :] + pair_b.long()[:, None] * 151 + rnd * 977) % n_valid).to(
        torch.float32) / n_valid.to(torch.float32)
    _, dst_list = top_k(fma(1e-4, jit_d, d_pref), c_dst)
    return dst_list.to(torch.int32)


def _row_cell_argmax(cells, blocked, neg_inf):
    """(rows, ci, best): each row's best cell not blocked (ties to the
    lowest cell; a row with none left gives cell 0 and -inf)."""
    masked = torch.where(blocked, neg_inf, cells)
    ci = torch.argmax(masked, dim=1)
    rows0 = torch.arange(cells.shape[0], dtype=torch.int64, device=cells.device)
    return rows0, ci, masked[rows0, ci]


def _block_cells(blocked, rows0, ci, dead, sel=None, row_cells=None):
    """Mark each row's nominated cell dead where `dead`; where `sel`, also
    the cells `row_cells` [V, X] of that row (all of them when None)."""
    blocked[rows0, ci] |= dead
    if sel is not None:
        if row_cells is None:
            blocked |= sel[:, None]
        else:
            blocked[rows0[:, None], row_cells] |= sel[:, None]


def make_pair_drain_round(goal, dims, n_pairs: int, apply_waves: int):
    """Drain round for TopicReplicaDistributionGoal (drain.py:308): the
    top-V (topic, broker) surplus pairs, a few replicas each (K6), scored
    against a per-pair destination list (K3), applied in waves (K4)."""
    p_count = dims.num_partitions
    t_count, b_count = dims.num_topics, dims.num_brokers
    v = max(1, min(n_pairs, b_count))
    k = min(4, p_count)
    c_dst = min(64, b_count)
    waves = max(1, apply_waves)

    def pair_round(static: StaticCtx, agg: Aggregates, tables, gs, contrib, rnd: int = 0):
        dev = agg.assignment.device
        neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
        pair_t, pair_b, pair_ok = select_surplus_pairs(static, agg, tables, gs, rnd, v, t_count,
                                                       b_count)
        cand_p, cand_s, found = pair_replica_picks(static, agg, pair_t, pair_b, k, b_count)
        cand_ok = found & pair_ok[:, None]
        dst_list = topic_dst_list(static, agg, tables, gs, pair_t, pair_b, rnd, c_dst, b_count)
        kind_move = torch.tensor(KIND_MOVE, dtype=torch.int32, device=dev)
        s = score_candidates(static, agg, tables, goal, gs, cand_p[:, :, None], kind_move,
                             cand_s[:, :, None], dst_list[:, None, :])
        cells = torch.where(cand_ok[:, :, None], s, neg_inf).reshape(v, k * c_dst)
        blocked = torch.zeros((v, k * c_dst), dtype=torch.bool, device=dev)
        applied_any = torch.zeros((), dtype=torch.bool, device=dev)
        move_kind = torch.full((v,), KIND_MOVE, dtype=torch.int32, device=dev)
        for w in range(waves):
            rows0, ci, bs = _row_cell_argmax(cells, blocked, neg_inf)
            k_i = ci // c_dst
            p_i, s_i = cand_p[rows0, k_i], cand_s[rows0, k_i]
            dst = dst_list[rows0, ci % c_dst]
            s_now = score_candidates(static, agg, tables, goal, gs, p_i, move_kind, s_i, dst)
            ok = torch.isfinite(bs) & torch.isfinite(s_now)
            sel = apply_wave(static, agg, p_i.contiguous(), move_kind, s_i.contiguous(),
                             dst.contiguous(), s_now.contiguous(), ok, make_touch_tag(rnd, w))
            dead = sel | (torch.isfinite(bs) & ~torch.isfinite(s_now))
            cols = (k_i * c_dst)[:, None] + torch.arange(c_dst, device=dev)[None, :]
            _block_cells(blocked, rows0, ci, dead, sel, cols)
            applied_any = applied_any | torch.any(sel)
        return agg, applied_any

    return pair_round


def topic_swap_validate(static: StaticCtx, agg: Aggregates, tables, gs, p1, s1, b, p2, s2, d):
    """f32[...]: the improvement of each topic-swap cell (replica (p1, s1) of
    broker b exchanged with (p2, s2) of broker d; drain.py:485), -inf where
    the swap is not legal or does not improve. Cells with a negative p1, p2,
    b or d are masked. The plain version of K5's TOPIC_SWAP."""
    from cruise_control_torch.analyzer.acceptance import swap_tables_acceptance

    masked = (p1 < 0) | (p2 < 0) | (b < 0) | (d < 0)
    p1, s1, b, p2, s2, d = (torch.clamp(x, min=0).long() for x in (p1, s1, b, p2, s2, d))
    a = agg.assignment
    still = (a[p1, s1] == b) & (a[p2, s2] == d) & (b != d) & (p1 != p2)
    still = still & static.movable_partition[p1] & static.movable_partition[p2]
    still = still & static.replica_dst_ok[d] & static.replica_dst_ok[b]
    still = still & ~torch.any(a[p1] == d[..., None], dim=-1)
    still = still & ~torch.any(a[p2] == b[..., None], dim=-1)
    still = still & (_rack_safe(static, agg, p1, b, p2, d) | ~tables.rack_enabled)
    still = still & ((s1 != 0) | static.leadership_dst_ok[d])
    still = still & ((s2 != 0) | static.leadership_dst_ok[b])
    kind = torch.tensor(KIND_MOVE, dtype=torch.int32, device=a.device)
    mv1 = build_selected(static.part_load, a, p1, kind, s1, d)
    mv2 = build_selected(static.part_load, a, p2, kind, s2, b)
    still = still & swap_tables_acceptance(static, tables, agg, mv1, mv2)
    t1, t2 = static.topic_id[p1].long(), static.topic_id[p2].long()
    trc = agg.topic_replica_count

    def imb(t, cnt):
        return imbalance(cnt.to(torch.float32), gs.lower[t], gs.upper[t])

    c1b, c1d, c2d, c2b = trc[t1, b], trc[t1, d], trc[t2, d], trc[t2, b]
    delta = (imb(t1, c1b - 1) - imb(t1, c1b) + imb(t1, c1d + 1) - imb(t1, c1d)
             + imb(t2, c2d - 1) - imb(t2, c2d) + imb(t2, c2b + 1) - imb(t2, c2b))
    improvement = -torch.where(t1 == t2, torch.zeros_like(delta), delta)
    ok = still & (improvement > 1e-6) & ~masked
    return torch.where(ok, improvement, torch.tensor(-torch.inf, device=a.device))


def _rack_safe(static, agg, p1, b, p2, d):
    """bool[...]: neither partition keeps a sibling on the other broker's rack
    after the exchange (the departing replica excepted on a shared rack)."""
    rack_b, rack_d = static.broker_rack[b].long(), static.broker_rack[d].long()
    same = (rack_b == rack_d).to(agg.rack_replica_count.dtype)
    rc = agg.rack_replica_count
    return ((rc[p1, rack_d] - same) == 0) & ((rc[p2, rack_b] - same) == 0)


def _valid_or(p, bs):
    """p where the wave's nominated cell is finite, else -1 (K5 masks it)."""
    return torch.where(torch.isfinite(bs), p, torch.full_like(p, -1))


def make_topic_swap_round(goal, dims, n_pairs: int, d_dst: int, k_ret: int, apply_waves: int):
    """Swap fallback for TopicReplicaDistributionGoal (drain.py:431): a
    surplus pair's replica exchanged with a similar-load replica of an
    under-count destination, validated by K5 and applied two legs at a time
    by K4."""
    p_count, r = dims.num_partitions, dims.max_rf
    t_count, b_count = dims.num_topics, dims.num_brokers
    v = max(1, min(n_pairs, b_count))
    d_dst = max(1, min(d_dst, b_count))
    k_ret = max(1, min(k_ret, p_count))
    waves = max(1, apply_waves)

    def swap_round(static: StaticCtx, agg: Aggregates, tables, gs, rnd: int):
        dev = agg.assignment.device
        neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
        pair_t, pair_b, pair_ok = select_surplus_pairs(static, agg, tables, gs, rnd, v, t_count,
                                                       b_count)
        c1p, c1s, c_found = pair_replica_picks(static, agg, pair_t, pair_b, 2, b_count)
        use_second = (rnd % 2 == 1) & c_found[:, 1]
        p1 = torch.where(use_second, c1p[:, 1], c1p[:, 0])
        s1 = torch.where(use_second, c1s[:, 1], c1s[:, 0])
        cand_ok = c_found[:, 0] & pair_ok
        dsts = topic_dst_list(static, agg, tables, gs, pair_t, pair_b, rnd, d_dst, b_count)

        # return candidates: each destination's lightest and heaviest replicas
        p_all = torch.arange(p_count, dtype=torch.int32, device=dev)
        is_leader = (torch.arange(r, device=dev) == 0)[None, :]
        load_l1 = torch.where(is_leader, load_total(_leader_vec(static.part_load, p_all))[:, None],
                              load_total(_follower_vec(static.part_load, p_all))[:, None])
        k_half = max(1, k_ret // 2)
        lp, ls, lok = broker_topk(load_l1, agg.assignment, static.movable_partition, k_half,
                                  b_count, heaviest=False)
        hp, hs, hok = broker_topk(load_l1, agg.assignment, static.movable_partition,
                                  k_ret - k_half, b_count, heaviest=True)
        ret_p = torch.cat([lp, hp], dim=1)
        ret_s = torch.cat([ls, hs], dim=1)
        ret_ok = torch.cat([lok, hok], dim=1)

        # the [V, D, K] grid, read by K5 through broadcast strides; a cell
        # without both picks is masked by a -1 partition
        g_p2, g_s2 = ret_p[dsts.long()], ret_s[dsts.long()]
        g_p2_ok = torch.where(ret_ok[dsts.long()], g_p2, -1)
        p1_ok = torch.where(cand_ok, p1, torch.full_like(p1, -1))
        kind = torch.tensor(TOPIC_SWAP, device=dev)
        cells = score_swaps(kind, static, agg, tables, gs, p1_ok[:, None, None],
                            s1[:, None, None], pair_b[:, None, None], g_p2_ok, g_s2,
                            dsts[:, :, None]).reshape(v, d_dst * k_ret)
        blocked = torch.zeros((v, d_dst * k_ret), dtype=torch.bool, device=dev)
        applied_any = torch.zeros((), dtype=torch.bool, device=dev)
        move_kind = torch.full((v,), KIND_MOVE, dtype=torch.int32, device=dev)
        for w in range(waves):
            rows0, ci, bs = _row_cell_argmax(cells, blocked, neg_inf)
            j, kk = ci // k_ret, ci % k_ret
            d_i = dsts[rows0, j]
            p2, s2 = g_p2[rows0, j, kk], g_s2[rows0, j, kk]
            out = score_swaps(kind, static, agg, tables, gs, _valid_or(p1, bs), s1, pair_b,
                              p2, s2, d_i)
            ok = torch.isfinite(out)
            sel = apply_wave(static, agg, p1.contiguous(), move_kind, s1.contiguous(),
                             d_i.contiguous(), out, ok, make_touch_tag(rnd, w),
                             leg2=(p2.contiguous(), move_kind, s2.contiguous(), pair_b))
            dead = sel | (torch.isfinite(bs) & ~ok)
            _block_cells(blocked, rows0, ci, dead, sel)
            applied_any = applied_any | torch.any(sel)
        return agg, applied_any

    return swap_round


# -- LeaderBytesInDistributionGoal: leadership relays ---------------------------------


def _relay_endpoint_ok(tables, agg, x, dload, dlnw, dcnt):
    """bool[...]: broker x's bounds after a relay's net change at x
    (drain.py:672): the hard load box, the band as a box, the leader
    bytes-in cap and the leader-count box."""
    inc = dload > 0.0
    after = agg.broker_load[x] + dload
    ok = torch.all(~inc | (after <= tables.hi_load[x]), dim=-1)
    band = torch.where(inc, after <= tables.band_hi[x], after >= tables.band_lo[x])
    ok = ok & torch.all((dload == 0.0) | ~tables.band_on | band, dim=-1)
    ok = ok & ((dlnw <= 0.0) | (agg.leader_nw_in[x] + dlnw <= tables.hi_lnw[x]))
    cnt_after = (agg.leader_count[x] + dcnt).to(torch.float32)
    ok = ok & ((dcnt <= 0) | (cnt_after <= tables.hi_lead[x]))
    ok = ok & ((dcnt >= 0) | (cnt_after >= tables.lo_lead[x]))
    return ok


def relay_validate(static: StaticCtx, agg: Aggregates, tables, gs, p1, s1, b, p2, s2, d):
    """f32[...]: the improvement of each relay cell (leadership of p1 moves
    b -> d by promoting slot s1, leadership of p2 moves d -> e =
    assignment[p2, s2]; drain.py:692), -inf where it is not legal or does not
    improve. Cells with a negative p1, p2, b or d are masked. The plain
    version of K5's LEADERSHIP_RELAY."""
    masked = (p1 < 0) | (p2 < 0) | (b < 0) | (d < 0)
    p1, s1, b, p2, s2, d = (torch.clamp(x, min=0).long() for x in (p1, s1, b, p2, s2, d))
    a = agg.assignment
    e_raw = a[p2, s2]
    e = torch.clamp(e_raw, min=0).long()
    still = (a[p1, 0] == b) & (a[p1, s1] == d)
    still = still & (a[p2, 0] == d) & (e_raw >= 0)
    still = still & (b != d) & (d != e) & (p1 != p2) & (s1 >= 1) & (s2 >= 1)
    still = still & static.movable_partition[p1] & static.movable_partition[p2]
    still = still & static.leadership_dst_ok[d] & static.leadership_dst_ok[e]
    kind = torch.tensor(KIND_LEADERSHIP, dtype=torch.int32, device=a.device)
    act1 = build_selected(static.part_load, a, p1, kind, s1, d)
    act2 = build_selected(static.part_load, a, p2, kind, s2, e)
    eb = e == b
    ebl = eb[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    dl1, dl2 = act1.dload, act2.dload
    w1, w2 = act1.dleader_nw_in, act2.dleader_nw_in
    delta_b = -dl1 + torch.where(ebl, dl2, zero)
    delta_d = dl1 - dl2
    delta_e = torch.where(ebl, zero, dl2)
    lnw_b = -w1 + torch.where(eb, w2, zero)
    lnw_d = w1 - w2
    lnw_e = torch.where(eb, zero, w2)
    izero = torch.zeros((), dtype=torch.int32, device=a.device)
    cnt_b = torch.where(eb, izero, izero - 1)
    cnt_e = torch.where(eb, izero, izero + 1)
    still = still & _relay_endpoint_ok(tables, agg, b, delta_b, lnw_b, cnt_b)
    still = still & _relay_endpoint_ok(tables, agg, d, delta_d, lnw_d, izero)
    still = still & _relay_endpoint_ok(tables, agg, e, delta_e, lnw_e, cnt_e)
    cb, cd, ce = delta_b[..., 0], delta_d[..., 0], delta_e[..., 0]
    host = static.broker_host
    hb, hd, he = host[b], host[d], host[e]

    def host_ok(h):
        tot = (torch.where(hb == h, cb, zero) + torch.where(hd == h, cd, zero)
               + torch.where(he == h, ce, zero))
        hl = h.long()
        return (tot <= 0.0) | (agg.host_cpu_load[hl] + tot <= tables.hi_host_cpu[hl])

    still = still & host_ok(hb) & host_ok(hd) & host_ok(he)
    lnw = agg.leader_nw_in

    def imb(x):
        return imbalance(x, gs.lower, gs.upper)

    before = imb(lnw[b]) + imb(lnw[d]) + torch.where(eb, zero, imb(lnw[e]))
    after = (imb(lnw[b] + lnw_b) + imb(lnw[d] + lnw_d)
             + torch.where(eb, zero, imb(lnw[e] + lnw_e)))
    improvement = before - after
    ok = still & (improvement > 1e-6) & ~masked
    return torch.where(ok, improvement, torch.tensor(-torch.inf, device=a.device))


def relay_grid(static: StaticCtx, agg: Aggregates, gs, goal, rnd: int, v: int, k1: int,
               k2: int, num_brokers: int):
    """The relay round's candidates (drain.py:762-822): the top-V over-bound
    sources `hot` i32[V], their K1 leaders closest in weight to the excess
    (c1p [V, K1]), every broker's K2 lightest and heaviest leaders (ret_p
    [B, K2], unmasked), and the six K5 index tensors of the
    [V, K1, R-1, K2, R-1] grid, broadcast lazily, masked cells -1."""
    a = agg.assignment
    dev = a.device
    p_count, r = a.shape
    neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
    rank = torch.where(static.dead, neg_inf, goal.src_rank(static, gs, agg))
    _, hot = top_k(rank, v)
    hot_ok = torch.isfinite(rank[hot])
    hot = hot.to(torch.int32)

    rot = round_jitter(p_count, rnd, dev)
    w_all = static.part_load[:, PartMetric.NW_IN_LEADER]
    is_leader = (torch.arange(r, device=dev) == 0)[None, :]
    excess = torch.clamp(agg.leader_nw_in - gs.upper, min=0.0)
    closeness = -torch.abs(w_all - excess[torch.clamp(a[:, 0], min=0).long()])
    contrib = torch.where(is_leader, (closeness * rot)[:, None], neg_inf)
    c1p, _, c1ok = heavy_picks(static, agg, contrib.contiguous(), hot, k1, num_brokers)
    c1ok = c1ok & hot_ok[:, None]

    lead_w = (torch.where(is_leader, w_all[:, None], neg_inf) * rot[:, None]).contiguous()
    k2l = max(1, k2 // 2)
    ret_p, _, ret_ok = broker_topk(lead_w, a, static.movable_partition, k2l, num_brokers,
                                   heaviest=False)
    if k2 - k2l > 0:
        hp, _, hok = broker_topk(lead_w, a, static.movable_partition, k2 - k2l, num_brokers,
                                 heaviest=True)
        ret_p, ret_ok = torch.cat([ret_p, hp], dim=1), torch.cat([ret_ok, hok], dim=1)

    s1_all = torch.arange(1, r, dtype=torch.int32, device=dev)
    g_s1 = s1_all[None, None, :, None, None]
    g_d = a[c1p.long()[:, :, None, None, None], g_s1.long()]
    k2i = torch.arange(k2, device=dev)[None, None, None, :, None]
    g_p2 = torch.where(ret_ok, ret_p, -1)[torch.clamp(g_d, min=0).long(), k2i]
    grid = (torch.where(c1ok, c1p, -1)[:, :, None, None, None], g_s1,
            hot[:, None, None, None, None], g_p2, s1_all[None, None, None, None, :], g_d)
    return hot, c1p, ret_p, grid


def make_leadership_relay_round(goal, dims, n_src: int, k_out: int, k_ret: int,
                                apply_waves: int):
    """Leadership-relay fallback for LeaderBytesInDistributionGoal
    (drain.py:631): promote a heavy leader p1 of an over-bound broker b to
    its follower at d, and one of d's leaders p2 to its follower at e. The
    [V, K1, R-1, K2, R-1] grid and each wave are validated by K5 and applied
    two legs at a time by K4, claiming all three brokers."""
    p_count, r = dims.num_partitions, dims.max_rf
    b_count = dims.num_brokers
    v = max(1, min(n_src, b_count))
    k1 = max(1, min(k_out, p_count))
    k2 = max(1, min(k_ret, p_count))
    r_f = r - 1
    n_cells = k1 * r_f * k2 * r_f
    waves = max(1, apply_waves)

    def relay_round(static: StaticCtx, agg: Aggregates, tables, gs, rnd: int):
        dev = agg.assignment.device
        neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
        a = agg.assignment
        hot, c1p, ret_p, grid = relay_grid(static, agg, gs, goal, rnd, v, k1, k2, b_count)
        s1_all = torch.arange(1, r, dtype=torch.int32, device=dev)
        kind = torch.tensor(LEADERSHIP_RELAY, device=dev)
        cells = score_swaps(kind, static, agg, tables, gs, *grid).reshape(v, n_cells)
        blocked = torch.zeros((v, n_cells), dtype=torch.bool, device=dev)
        applied_any = torch.zeros((), dtype=torch.bool, device=dev)
        lead_kind = torch.full((v,), KIND_LEADERSHIP, dtype=torch.int32, device=dev)
        for w in range(waves):
            rows0, ci, bs = _row_cell_argmax(cells, blocked, neg_inf)
            i1 = ci // (r_f * k2 * r_f)
            s1 = s1_all[(ci // (k2 * r_f)) % r_f]
            i2 = (ci // r_f) % k2
            s2 = s1_all[ci % r_f]
            p1 = c1p[rows0, i1]
            d_i = torch.clamp(a[p1.long(), s1.long()], min=0)
            p2 = ret_p[d_i.long(), i2]
            out = score_swaps(kind, static, agg, tables, gs, _valid_or(p1, bs), s1, hot, p2,
                              s2, d_i)
            ok = torch.isfinite(out)
            e_i = torch.clamp(a[p2.long(), s2.long()], min=0)
            sel = apply_wave(static, agg, p1.contiguous(), lead_kind, s1.contiguous(),
                             d_i.contiguous(), out, ok, make_touch_tag(rnd, w),
                             leg2=(p2.contiguous(), lead_kind, s2.contiguous(), e_i.contiguous()),
                             brokers3=True)
            dead = sel | (torch.isfinite(bs) & ~ok)
            _block_cells(blocked, rows0, ci, dead, sel)
            applied_any = applied_any | torch.any(sel)
        return agg, applied_any

    return relay_round
