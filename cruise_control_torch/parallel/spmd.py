"""Explicit SPMD kernels over the partition-axis mesh.

The JAX package's parallel/spmd.py on torch. There a `shard_map` runs each
kernel once a device; here one process drives every shard in turn (the mesh
is single-controller, as the JAX one is), entering each shard's card with a
device guard: the kernels' launch state and scratch are per card.

make_grid_shortlist (the greedy grid's round, JAX :95):

  1. **Local scoring.** K9 (kernels/grid_shortlist.py) scores the shard's
     P/D rows of the [P, R, K] move grid and the [P, R-1] promotion grid
     against the whole broker state and keeps the shard's best: a cell's
     score reads only its own partition's rows, so each shard's
     per-partition best is bit-identical to the unsharded one.
  2. **Local top-k**, k_loc = min(k_sel, P/D) records a shard, each with
     its shard's local row.
  3. **One all-gather.** The records land in one [D, k_loc] tensor of
     scores and one [D, k_loc, 4] of (local partition, kind, slot, dst) on
     the mesh's first device; a shard there writes its record in place.
  4. **Deterministic merge.** K12 (kernels/shard_merge.py) offsets each
     record's row to the global one (JAX's int32 `axis_index * p_local`),
     orders them by (-score, global partition), `lax.top_k`'s order, and
     keeps k_sel: a grid round is D K9 launches and one K12, nothing
     between. The shortlist, the only cross-shard decision, is the
     unsharded one, so a mesh-N run makes a mesh-1 run's decisions.

make_partition_stats (JAX :208): K13 (kernels/partition_stats.py) counts a
shard's movable rows, populated slots and rows; the counts are gathered and
summed as integers (`psum`), which no order of the sum can perturb.

Each gather is metered as an `all-gather` and each integer sum as an
`all-reduce` (common/telemetry.py `collective_totals`), as they happen.
With every shard on one card nothing crosses a link. A shard on another card
reads copies, made with `.to(..., non_blocking=True)` on the current
streams: that path has not run on more than one card.
"""

from __future__ import annotations

import contextlib

import torch

from cruise_control_torch.common.telemetry import TELEMETRY
from cruise_control_torch.kernels.grid_shortlist import grid_shortlist, grid_shortlist_plain
from cruise_control_torch.kernels.partition_stats import partition_stats, partition_stats_plain
from cruise_control_torch.kernels.shard_merge import shard_merge, shard_merge_plain
from cruise_control_torch.parallel.sharding import (
    Mesh,
    place_aggregates,
    place_replicated,
    static_shards,
)

#: the entry points' names (the JAX package's lint/entrypoints.py :326-327),
#: which tag their collectives in the telemetry
GRID_SHORTLIST_ENTRY = "spmd-grid-shortlist"
PARTITION_STATS_ENTRY = "spmd-partition-stats"
#: bytes of one shortlist record: a score and four int32
_RECORD_BYTES = 20


def on_device(device: torch.device):
    """A guard that makes `device` the current card (nothing on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def make_grid_shortlist(mesh: Mesh, goal, dims, settings):
    """The greedy round's shortlist on the mesh, for one goal:
    shortlist(static, agg, gs, tables, dst_cands) -> (top_scores f32[k_sel],
    sel_p, sel_kind, sel_slot, sel_dst i32[k_sel]) on the mesh's first
    device, equal to the unsharded shortlist. `static` is best a
    `sharding.place_static` context (its shards are cut once; another
    context is cut at each call); dims.num_partitions must be a multiple of
    mesh.size (the optimizer pads to it). `shortlist.plain` is the same with
    the plain versions: grid_shortlist_plain a shard, shard_merge_plain."""
    from cruise_control_torch.analyzer.optimizer import bucket_label

    p_count, n_dev = dims.num_partitions, mesh.size
    if p_count % n_dev:
        raise ValueError(f"partition axis {p_count} not divisible by mesh size {n_dev}")
    p_local = p_count // n_dev
    k_sel = max(1, min(settings.batch_k, p_count))
    # a shard smaller than the shortlist contributes all its rows, so the
    # gathered union holds the global top k_sel
    k_loc = min(k_sel, p_local)
    first = mesh.devices[0]
    bucket = bucket_label(dims)

    def run(static, agg, gs, tables, dst_cands, local, merge):
        shards = static_shards(static, mesh)
        aggs = place_aggregates(agg, mesh)
        reps = place_replicated((gs, tables, dst_cands), mesh)
        g_score = torch.empty((n_dev, k_loc), dtype=torch.float32, device=first)
        g_rec = torch.empty((n_dev, k_loc, 4), dtype=torch.int32, device=first)
        for i, d in enumerate(mesh.devices):
            gs_i, tables_i, cands_i = reps[i]
            with on_device(d):
                if d == first:
                    local(shards[i], aggs[i], tables_i, goal, gs_i, cands_i, k_loc,
                          out=(g_score[i], g_rec[i]))
                    continue
                s_i = torch.empty(k_loc, dtype=torch.float32, device=d)
                rec_i = torch.empty((k_loc, 4), dtype=torch.int32, device=d)
                local(shards[i], aggs[i], tables_i, goal, gs_i, cands_i, k_loc, out=(s_i, rec_i))
            g_score[i].copy_(s_i, non_blocking=True)
            g_rec[i].copy_(rec_i, non_blocking=True)
        TELEMETRY.record_collective("all-gather", n_dev * k_loc * _RECORD_BYTES, bucket,
                                    GRID_SHORTLIST_ENTRY, per_round=True)
        top_scores, sel = merge(g_score.view(-1), g_rec.view(-1, 4), k_sel, k_loc, p_local)
        return (top_scores, *sel.unbind(0))

    def plain_local(static, agg, tables, goal_, gs, dst_cands, k, out):
        res = grid_shortlist_plain(static, agg, tables, goal_, gs, dst_cands, k)
        out[0].copy_(res[0])
        out[1].copy_(torch.stack(res[1:], dim=1))

    def shortlist(static, agg, gs, tables, dst_cands):
        return run(static, agg, gs, tables, dst_cands, grid_shortlist, shard_merge)

    def plain(static, agg, gs, tables, dst_cands):
        return run(static, agg, gs, tables, dst_cands, plain_local, shard_merge_plain)

    shortlist.plain = plain
    return shortlist


def make_partition_stats(mesh: Mesh):
    """stats(static, agg) -> (movable, assigned_slots, rows), each an i32[]
    on the mesh's first device: the mesh-wide counts, each the integer sum of
    the shards' (the coverage certificate: every row is owned by exactly one
    shard). `stats.plain` is the same with the plain version a shard."""
    first = mesh.devices[0]

    def run(static, agg, local):
        shards = static_shards(static, mesh)
        aggs = place_aggregates(agg, mesh)
        counts = torch.empty((mesh.size, 3), dtype=torch.int32, device=first)
        for i, d in enumerate(mesh.devices):
            with on_device(d):
                c = local(shards[i].movable_partition, aggs[i].assignment,
                          out=counts[i] if d == first else None)
            if d != first:
                counts[i].copy_(c, non_blocking=True)
        TELEMETRY.record_collective("all-reduce", mesh.size * 3 * 4,
                                    f"mesh{mesh.size}-P{agg.assignment.shape[0]}",
                                    PARTITION_STATS_ENTRY, per_round=False)
        total = torch.sum(counts, dim=0, dtype=torch.int32)
        return total[0], total[1], total[2]

    def plain_local(movable, assignment, out=None):
        c = partition_stats_plain(movable, assignment)
        return c if out is None else out.copy_(c)

    def stats(static, agg):
        return run(static, agg, partition_stats)

    stats.plain = lambda static, agg: run(static, agg, plain_local)
    return stats
