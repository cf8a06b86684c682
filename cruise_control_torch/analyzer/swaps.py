"""Replica swap round for the resource-distribution goals.

The counterpart of the JAX package's analyzer/swaps.py (itself the array form
of ResourceDistributionGoal's rebalanceBySwapping*, :482 / :610): when single
moves stall, exchange a heavy replica of a hot broker for a light replica of
a cold one. The top-N hot brokers' K heaviest candidates (K2) against the
top-N cold brokers' K lightest (K2) make an [N, N, K, K] grid that K5 scores
in one launch through broadcast strides; per wave each hot broker nominates
one cell (cold partner rotated by the wave, the last wave over all
partners), K5 re-validates the nominations on the current aggregates and K4
applies a disjoint subset, both legs. Every K5 launch of a round reads one
context packed once (`swap_context`).

`replica_swap_grid` and `replica_swap_revalidate` are K5's plain versions.
"""

from __future__ import annotations

import torch

from cruise_control_torch.analyzer.acceptance import swap_tables_acceptance
from cruise_control_torch.analyzer.actions import KIND_MOVE, build_selected, slot_contrib
from cruise_control_torch.analyzer.context import Aggregates, StaticCtx, apply_wave, make_touch_tag
from cruise_control_torch.analyzer.goals.base import SCORE_EPS
from cruise_control_torch.common.resources import PartMetric, Resource
from cruise_control_torch.kernels.score_swaps import REPLICA_SWAP, score_swaps, swap_context


def _dist(u, gs):
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    return torch.maximum(zero, u - gs.upper) + torch.maximum(zero, gs.lower - u)


def _all_res_contrib(static: StaticCtx, p, slot) -> torch.Tensor:
    """f32[..., 4]: the full per-Resource load of replica (p, slot)."""
    from cruise_control_torch.analyzer.actions import _follower_vec, _leader_vec

    return torch.where((slot == 0)[..., None], _leader_vec(static.part_load, p),
                       _follower_vec(static.part_load, p))


def _neither_hosts(agg, p1, cold, p2, hot):
    a = agg.assignment
    return (~torch.any(a[p1] == cold[..., None], dim=-1)
            & ~torch.any(a[p2] == hot[..., None], dim=-1))


def _rack_safe_or_off(static, agg, tables, p1, hot, p2, cold):
    rack_h, rack_c = static.broker_rack[hot].long(), static.broker_rack[cold].long()
    same = (rack_h == rack_c).to(agg.rack_replica_count.dtype)
    rc = agg.rack_replica_count
    safe = ((rc[p1, rack_c] - same) == 0) & ((rc[p2, rack_h] - same) == 0)
    return safe | ~tables.rack_enabled


def replica_swap_grid(static: StaticCtx, agg: Aggregates, tables, gs, res: int, p1, s1, hot,
                      p2, s2, cold):
    """f32[...]: the round-start score of each swap cell, replica (p1, s1) of
    broker `hot` against (p2, s2) of broker `cold` (swaps.py:98-194): the
    imbalance the pair loses, -inf where the swap is not legal, does not
    move load hot -> cold, or makes either broker worse. A negative p1, p2,
    hot or cold masks the cell."""
    masked = (p1 < 0) | (p2 < 0) | (hot < 0) | (cold < 0)
    p1, s1, hot, p2, s2, cold = (torch.clamp(x, min=0).long() for x in (p1, s1, hot, p2, s2, cold))
    dev = agg.assignment.device
    cap = torch.clamp(static.broker_capacity[:, res], min=1e-9)
    util = agg.broker_load[:, res] / cap
    contrib = slot_contrib(static.part_load, agg.assignment, res)
    delta = contrib[p1, s1] - contrib[p2, s2]
    ok = (delta > SCORE_EPS) & (hot != cold) & (p1 != p2)
    kind = torch.tensor(KIND_MOVE, dtype=torch.int32, device=dev)
    mv1 = build_selected(static.part_load, agg.assignment, p1, kind, s1, cold)
    mv2 = build_selected(static.part_load, agg.assignment, p2, kind, s2, hot)
    ok = ok & swap_tables_acceptance(static, tables, agg, mv1, mv2)
    ok = ok & _neither_hosts(agg, p1, cold, p2, hot)
    ok = ok & _rack_safe_or_off(static, agg, tables, p1, hot, p2, cold)
    ok = ok & ((s1 != 0) | static.leadership_dst_ok[cold])
    ok = ok & ((s2 != 0) | static.leadership_dst_ok[hot])
    # capacity and potential NW_OUT must not get worse on either end
    net = _all_res_contrib(static, p1, s1) - _all_res_contrib(static, p2, s2)
    hot_before, cold_before = agg.broker_load[hot], agg.broker_load[cold]
    hot_limit = torch.maximum(static.capacity_limit[hot], hot_before)
    cold_limit = torch.maximum(static.capacity_limit[cold], cold_before)
    ok = ok & torch.all(hot_before - net <= hot_limit + 1e-6, dim=-1)
    ok = ok & torch.all(cold_before + net <= cold_limit + 1e-6, dim=-1)
    pnw1 = static.part_load[p1, PartMetric.NW_OUT_LEADER]
    pnw2 = static.part_load[p2, PartMetric.NW_OUT_LEADER]
    pnw_limit = static.capacity_limit[:, Resource.NW_OUT]
    pnw_cold0, pnw_hot0 = agg.potential_nw_out[cold], agg.potential_nw_out[hot]
    ok = ok & (pnw_cold0 + pnw1 - pnw2 <= torch.maximum(pnw_limit[cold], pnw_cold0) + 1e-6)
    ok = ok & (pnw_hot0 - pnw1 + pnw2 <= torch.maximum(pnw_limit[hot], pnw_hot0) + 1e-6)
    u_h, u_c = util[hot], util[cold]
    h0, h1 = _dist(u_h, gs), _dist(u_h - delta / cap[hot], gs)
    c0, c1 = _dist(u_c, gs), _dist(u_c + delta / cap[cold], gs)
    endpoint_ok = (h1 <= h0 + SCORE_EPS) & (c1 <= c0 + SCORE_EPS)
    # a swap moves non-immigrants: off under only_move_immigrants (swaps.py:98-103)
    ok = ok & endpoint_ok & gs.active & ~masked & ~static.only_move_immigrants
    return torch.where(ok, h0 + c0 - h1 - c1, torch.tensor(-torch.inf, device=dev))


def replica_swap_revalidate(static: StaticCtx, agg: Aggregates, tables, gs, res: int, p1, s1,
                            hot, p2, s2, cold):
    """f32[N]: a wave's re-validation of its nominated swaps on the current
    aggregates (swaps.py:255-282): the improvement, -inf where the swap is
    no longer legal or improving. A negative p1 or p2 masks the entry."""
    masked = (p1 < 0) | (p2 < 0) | (hot < 0) | (cold < 0)
    p1, s1, hot, p2, s2, cold = (torch.clamp(x, min=0).long() for x in (p1, s1, hot, p2, s2, cold))
    dev = agg.assignment.device
    a = agg.assignment
    cap = torch.clamp(static.broker_capacity[:, res], min=1e-9)
    contrib = slot_contrib(static.part_load, a, res)
    still = (a[p1, s1] == hot) & (a[p2, s2] == cold)
    still = still & _neither_hosts(agg, p1, cold, p2, hot)
    still = still & _rack_safe_or_off(static, agg, tables, p1, hot, p2, cold)
    u_h = agg.broker_load[hot, res] / cap[hot]
    u_c = agg.broker_load[cold, res] / cap[cold]
    d = contrib[p1, s1] - contrib[p2, s2]
    h0, h1 = _dist(u_h, gs), _dist(u_h - d / cap[hot], gs)
    c0, c1 = _dist(u_c, gs), _dist(u_c + d / cap[cold], gs)
    improve = h0 + c0 - h1 - c1
    endpoint_ok = (h1 <= h0 + SCORE_EPS) & (c1 <= c0 + SCORE_EPS)
    kind = torch.tensor(KIND_MOVE, dtype=torch.int32, device=dev)
    mv1 = build_selected(static.part_load, a, p1, kind, s1, cold)
    mv2 = build_selected(static.part_load, a, p2, kind, s2, hot)
    tables_ok = swap_tables_acceptance(static, tables, agg, mv1, mv2)
    ok = still & endpoint_ok & (improve > SCORE_EPS) & tables_ok & ~masked
    return torch.where(ok, improve, torch.tensor(-torch.inf, device=dev))


def swap_grid(static: StaticCtx, agg: Aggregates, res: int, contrib_in, n_pairs: int, k: int,
              num_brokers: int):
    """The round's candidates (swaps.py:80-111): the top-N hot and cold
    brokers by utilization of `res` (hot, cold i32[N]), their K heaviest and
    lightest drain candidates (hp, hs, cp, cs [N, K]), and the six K5 index
    tensors of the [N, N, K, K] grid, broadcast lazily, with missing picks
    and brokers without a finite rank masked by -1."""
    from cruise_control_torch.analyzer.drain import heavy_picks, light_picks, top_k

    neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=agg.assignment.device)
    cap = torch.clamp(static.broker_capacity[:, res], min=1e-9)
    util = agg.broker_load[:, res] / cap
    eligible = static.alive & static.replica_dst_ok
    hot_vals, hot = top_k(torch.where(eligible, util, neg_inf), n_pairs)
    cold_vals, cold = top_k(torch.where(eligible, -util, neg_inf), n_pairs)
    hot, cold = hot.to(torch.int32), cold.to(torch.int32)
    hp, hs, h_ok = heavy_picks(static, agg, contrib_in, hot, k, num_brokers)
    cp, cs, c_ok = light_picks(static, agg, contrib_in, cold, k, num_brokers)
    hot_g = torch.where(torch.isfinite(hot_vals), hot, -1)
    cold_g = torch.where(torch.isfinite(cold_vals), cold, -1)
    grid = (torch.where(h_ok, hp, -1)[:, None, :, None], hs[:, None, :, None],
            hot_g[:, None, None, None], torch.where(c_ok, cp, -1)[None, :, None, :],
            cs[None, :, None, :], cold_g[None, :, None, None])
    return hot, cold, hp, hs, cp, cs, grid


def make_swap_round(goal, dims, n_pairs: int = 8, k: int = 8, swaps_per_broker: int = 4,
                    apply_waves: int = 0):
    """Build swap_round(static, agg, tables, contrib_in, rnd) -> (agg, applied)
    for a resource-distribution goal; `agg` is updated in place."""
    res = goal.resource
    p_count = dims.num_partitions
    n_pairs = max(1, min(n_pairs, dims.num_brokers // 2 or 1))
    k = max(1, min(k, p_count))
    waves = max(apply_waves, swaps_per_broker, 4)

    def swap_round(static: StaticCtx, agg: Aggregates, tables, contrib_in, rnd: int = -1):
        dev = agg.assignment.device
        neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
        gs = goal.prepare(static, agg, dims)
        hot, cold, hp, hs, cp, cs, grid = swap_grid(static, agg, res, contrib_in, n_pairs, k,
                                                    dims.num_brokers)
        ctx = swap_context(None, static, agg, tables, gs)
        score = score_swaps(REPLICA_SWAP, static, agg, tables, gs, *grid, resource=res, ctx=ctx)
        rows0 = torch.arange(n_pairs, dtype=torch.int64, device=dev)
        move_kind = torch.full((n_pairs,), KIND_MOVE, dtype=torch.int32, device=dev)
        blocked = torch.zeros(score.shape, dtype=torch.bool, device=dev)
        applied_any = torch.zeros((), dtype=torch.bool, device=dev)
        for w in range(waves):
            masked = torch.where(blocked, neg_inf, score)
            if w == waves - 1:
                flat = masked.reshape(n_pairs, n_pairs * k * k)
                bi = torch.argmax(flat, dim=1)
                j_idx, a_idx, b_idx = bi // (k * k), (bi // k) % k, bi % k
                bs = flat[rows0, bi]
            else:
                j_idx = (rows0 + w) % n_pairs
                block = masked[rows0, j_idx].reshape(n_pairs, k * k)
                bi = torch.argmax(block, dim=1)
                a_idx, b_idx = bi // k, bi % k
                bs = block[rows0, bi]
            p1, s1 = hp[rows0, a_idx], hs[rows0, a_idx]
            p2, s2 = cp[j_idx, b_idx], cs[j_idx, b_idx]
            c = cold[j_idx]
            out = score_swaps(REPLICA_SWAP, static, agg, tables, gs,
                              torch.where(torch.isfinite(bs), p1, -1), s1, hot, p2, s2, c,
                              resource=res, wave=True, ctx=ctx)
            ok = torch.isfinite(out)
            sel = apply_wave(static, agg, p1.contiguous(), move_kind, s1.contiguous(),
                             c.contiguous(), out, ok, make_touch_tag(rnd, w),
                             leg2=(p2.contiguous(), move_kind, s2.contiguous(), hot))
            dead = sel | (torch.isfinite(bs) & ~ok)
            blocked[rows0, j_idx, a_idx, b_idx] |= dead
            applied_any = applied_any | torch.any(sel)
        return agg, applied_any

    return swap_round
