"""K9: the greedy round's shortlist over its whole candidate space.

Replaces cruise_control_tpu/analyzer/optimizer.py one_round (:357), its
shortlist at :371-409: the [P, R, K] move grid and the [P, R-1] leadership
grid scored as acceptance.score_batch scores them, each partition's best
cell, and the best partition. The CUDA kernel is csrc/grid_shortlist.cu; it
scores every cell with K3's source and destination halves and their combine
(csrc/score_goal.cuh), a warp per group of partitions, and writes no score
to memory:
each block leaves one record of its best partition in a per-device scratch,
and a second launch reduces them. `grid_shortlist_plain` (K3's plain
version, argmax, `drain.top_k`) is the PyTorch version.
"""

from __future__ import annotations

import ctypes

import torch

from cruise_control_torch.analyzer.actions import (
    KIND_LEADERSHIP,
    KIND_MOVE,
    leadership_grid,
    make_move_batch,
)
from cruise_control_torch.analyzer.drain import top_k
from cruise_control_torch.kernels import build
from cruise_control_torch.kernels.score_candidates import bound_context, score_candidates_plain

#: per device: the blocks' records (csrc/grid_shortlist.cu BlockBest), with
#: its address; the workspace of the kernel's device-memory configuration
#: (a replication factor or a candidate count whose halves overflow shared
#: memory), grown on demand; the sizes last asked and their bytes. Calls on
#: one stream use them in turn.
_SCRATCH = {}
_WORK = {}
_WORK_SIZES = {}
_ARGTYPES = (build.PTR,) * 6 + (build.INT,) * 4 + (build.PTR,)


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


def _scratch(dev: int) -> int:
    addr = _SCRATCH.get(dev)
    if addr is None:
        lib = build.load("grid_shortlist")
        lib.grid_shortlist_scratch_bytes.restype = ctypes.c_longlong
        buf = torch.empty(int(lib.grid_shortlist_scratch_bytes()), dtype=torch.uint8,
                          device=torch.device("cuda", dev))
        _SCRATCH[dev] = addr = (buf, buf.data_ptr())
    return addr[1]


def _work(dev: int, r: int, k: int, p: int) -> int:
    """The address of device `dev`'s workspace for the kernel's device-memory
    configuration, grown to what a launch on these sizes takes (0: the
    launch keeps everything in shared memory)."""
    key = (r, k, p)
    if _WORK_SIZES.get(dev, (None,))[0] != key:
        fn = build.load("grid_shortlist").grid_shortlist_work_bytes
        fn.argtypes, fn.restype = [build.INT] * 3, build.INT
        _WORK_SIZES[dev] = (key, fn(r, k, p))
    need = _WORK_SIZES[dev][1]
    if need == 0:
        return 0
    ws = _WORK.get(dev)
    if ws is None or ws[0].numel() < need:
        buf = torch.empty(need, dtype=torch.uint8, device=torch.device("cuda", dev))
        ws = _WORK[dev] = (buf, buf.data_ptr())
    return ws[1]


def grid_shortlist(static, agg, tables, goal, gs, dst_cands, k: int = 1, ctx=None, out=None):
    """`grid_shortlist_plain` for CPU tensors, the CUDA kernel for CUDA
    tensors. The kernel takes the greedy round's k = 1 only. `ctx` is the
    round's ScoreContext (one is built when none is given). `out` = (score
    f32[k], record i32[k, 4]), both contiguous on the same device, takes the
    result in place of fresh tensors, each record (p, kind, slot, dst): the
    partition-axis mesh gathers the shards' records so (parallel/spmd.py)."""
    dev = agg.assignment.device
    if dev.type == "cpu":
        res = grid_shortlist_plain(static, agg, tables, goal, gs, dst_cands, k)
        if out is None:
            return res
        out[0].copy_(res[0])
        out[1].copy_(torch.stack(res[1:], dim=1))
        return (out[0], *out[1].unbind(1))
    if k != 1:
        raise ValueError(f"grid_shortlist: the kernel takes k = 1, got {k}")
    # the context lives through the call: the C entry reads its struct
    ctx = bound_context(ctx, static, agg, tables, goal, gs)
    address = ctx.pack("grid_shortlist")
    if dst_cands.dtype != torch.int32 or not dst_cands.is_contiguous():
        dst_cands = dst_cands.to(torch.int32).contiguous()
    build.require(dst_cands, torch.int32, 1, "dst_cands", dev)
    p_count, r = agg.assignment.shape
    if out is None:
        out_score = torch.empty(1, dtype=torch.float32, device=dev)
        out_idx = torch.empty(4, dtype=torch.int32, device=dev)
    else:
        out_score, out_idx = out[0], out[1].view(-1)
        build.require(out_score, torch.float32, 1, "out score", dev)
        build.require(out_idx, torch.int32, 1, "out record", dev)
        if out_score.shape[0] != 1 or out_idx.shape[0] != 4:
            raise ValueError("grid_shortlist: out must be (f32[1], i32[1, 4])")
    code = build.entry("grid_shortlist", _ARGTYPES)(
        address, out_score.data_ptr(), out_idx.data_ptr(), _scratch(dev.index),
        _work(dev.index, r, dst_cands.shape[0], p_count), dst_cands.data_ptr(), p_count,
        dst_cands.shape[0], 1 if goal.uses_moves else 0,
        1 if goal.uses_leadership and r >= 2 else 0, build.raw_stream(dev.index))
    if code:
        build.check(build.load("grid_shortlist"), code, "grid_shortlist")
    grid_shortlist.launches += 1
    return out_score, out_idx[0:1], out_idx[1:2], out_idx[2:3], out_idx[3:4]


grid_shortlist.launches = 0
