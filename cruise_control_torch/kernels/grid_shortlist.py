"""K9: the greedy round's shortlist over its whole candidate space.

Replaces cruise_control_tpu/analyzer/optimizer.py one_round (:357), its
shortlist at :371-409: the [P, R, K] move grid and the [P, R-1] leadership
grid scored as acceptance.score_batch scores them, each partition's best
cell, and the best partition. The CUDA kernel is csrc/grid_shortlist.cu; it
scores every cell with K3's `score_action` (csrc/score_goal.cuh) and writes
no score to memory. `grid_shortlist_plain` (K3's plain version, argmax,
`drain.top_k`) is the PyTorch version.
"""

from __future__ import annotations

import torch

from cruise_control_torch.analyzer.actions import (
    KIND_LEADERSHIP,
    KIND_MOVE,
    leadership_grid,
    make_move_batch,
)
from cruise_control_torch.analyzer.drain import top_k
from cruise_control_torch.kernels import build
from cruise_control_torch.kernels.score_candidates import score_candidates_plain, score_context


def grid_shortlist_plain(static, agg, tables, goal, gs, dst_cands, k: int = 1):
    """(top_score f32[k], p i32[k], kind i32[k], slot i32[k], dst i32[k]): the
    k best partitions' best actions. A partition's best move is the first
    maximum over its cells flattened as slot * K + j; its best promotion
    replaces it only when strictly better; the partitions rank by score,
    ties to the lowest index (lax.top_k's order). A leadership winner's
    destination is the broker now in its slot."""
    a = agg.assignment
    p_count, r = a.shape
    kk = dst_cands.shape[0]
    dev = a.device
    rows = torch.arange(p_count, device=dev)
    best_score = torch.full((p_count,), -torch.inf, dtype=torch.float32, device=dev)
    best_kind = torch.zeros(p_count, dtype=torch.int32, device=dev)
    best_slot = torch.zeros(p_count, dtype=torch.int32, device=dev)
    best_dst = torch.zeros(p_count, dtype=torch.int32, device=dev)
    if goal.uses_moves:
        s = score_candidates_plain(static, agg, tables, goal, gs,
                                   *make_move_batch(a, dst_cands))
        s = s.expand(p_count, r, kk).reshape(p_count, r * kk)
        j = torch.argmax(s, dim=1)
        best_score = s[rows, j]
        best_kind = torch.full((p_count,), KIND_MOVE, dtype=torch.int32, device=dev)
        best_slot = (j // kk).to(torch.int32)
        best_dst = dst_cands[j % kk].to(torch.int32)
    if goal.uses_leadership and r >= 2:
        sl = score_candidates_plain(static, agg, tables, goal, gs, *leadership_grid(a))
        sl = sl.expand(p_count, r - 1)
        j2 = torch.argmax(sl, dim=1)
        sbest = sl[rows, j2]
        lead_slot = (j2 + 1).to(torch.int32)
        take = sbest > best_score
        best_score = torch.maximum(best_score, sbest)
        best_kind = torch.where(take, KIND_LEADERSHIP, best_kind).to(torch.int32)
        best_slot = torch.where(take, lead_slot, best_slot)
        best_dst = torch.where(take, a[rows, lead_slot.long()], best_dst)
    top_score, top_p = top_k(best_score, k)
    return top_score, top_p.to(torch.int32), best_kind[top_p], best_slot[top_p], best_dst[top_p]


def grid_shortlist(static, agg, tables, goal, gs, dst_cands, k: int = 1):
    """`grid_shortlist_plain` for CPU tensors, the CUDA kernel for CUDA
    tensors. The kernel takes the greedy round's k = 1 only."""
    dev = agg.assignment.device
    if dev.type == "cpu":
        return grid_shortlist_plain(static, agg, tables, goal, gs, dst_cands, k)
    if k != 1:
        raise ValueError(f"grid_shortlist: the kernel takes k = 1, got {k}")
    ctx, ctx_ints = score_context(static, agg, tables, goal, gs, "grid_shortlist")
    dst_cands = dst_cands.to(torch.int32).contiguous()
    build.require(dst_cands, torch.int32, 1, "dst_cands", dev)
    p_count, r = agg.assignment.shape
    out_score = torch.empty(1, dtype=torch.float32, device=dev)
    out_idx = torch.empty(4, dtype=torch.int32, device=dev)
    key = torch.empty(1, dtype=torch.int64, device=dev)
    lib = build.load("grid_shortlist")
    code = lib.grid_shortlist(
        build.ptrs(out_score, out_idx, key, dst_cands, *ctx),
        build.ints(p_count, dst_cands.shape[0], 1 if goal.uses_moves else 0,
                   1 if goal.uses_leadership and r >= 2 else 0, *ctx_ints),
        build.stream())
    build.check(lib, code, "grid_shortlist")
    grid_shortlist.launches += 1
    return out_score, out_idx[0:1], out_idx[1:2], out_idx[2:3], out_idx[3:4]


grid_shortlist.launches = 0
