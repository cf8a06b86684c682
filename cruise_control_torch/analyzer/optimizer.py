"""Batched-greedy goal optimizer: the goal stack on the card.

The counterpart of the JAX package's analyzer/optimizer.py (itself the
replacement of GoalOptimizer.optimizations, cc/analyzer/GoalOptimizer.java:392)
for the settings this port carries: every engine of the default stack (the
drain/fill rounds, the bulk count planner, the replica swaps, the topic goal's
pair drain and topic swaps, the leadership relays) in batched mode
(`batch_k > 1`), the exhaustive `batch_k=1` greedy grid with its cost-scaled
round caps (`GREEDY_SETTINGS`), and the polish pass (`BENCH_SETTINGS`), run
either as the fused stack (`chunk_rounds = 0`) or through the chunked goal
machine (`chunk_rounds > 0`, the service default, `SERVICE_SETTINGS`), with
the provenance ledger and the before/after cluster statistics, at the exact
shape or padded to a shape bucket (`bucket_partitions`, `bucket_brokers`),
under any OptimizationOptions, for the default stack or a subset of it, or
for the kafka-assigner goals (their own machine).

The front half (`_prepare`) pads the model, builds the static context and
keeps both in a two-entry cache keyed by the identity of the caller's model
tensors and options (the JAX package's `_prep_cache`); the back half
(`_solve_prepared`) runs the goals on a prepared model. The incremental
lane (analyzer/incremental.py) arms from a cache entry and re-solves
through `incremental_optimizations`, the same `_solve_prepared`.

The JAX package runs each goal's rounds as a device `while_loop`; here the
round loop is a host loop over device work that reads one device value per
round, the loop condition (`empties`, optimizer.py:673-675 in the JAX code),
plus the bulk planner's and the fallbacks' `applied` flags. The goal
machine's cursor (phase, rounds in it, empty-round streak) is therefore
already on the host, and a machine call reads back only the per-goal round
counts (and, entering a polish phase, the goal's converged flag and
fingerprint).

Observability is the JAX optimizer's, on common/sensors.py's REGISTRY and
common/tracing.py's TRACER: a `proposal` span around each computation (an
armed profile dir captures one with the torch profiler), a `device-call`
span and `cc-machine-call` profiler range per machine call, synthetic `goal`
spans, a `provenance` span around the ledger, the prep cache's hit and miss
meters, the round, call, proposal and stack timers, and a sensor history
point at each proposal boundary (common/history.py). Left out: the JAX
package's program-cache meters, its stack-compile timers and its
`TELEMETRY` calls, which are tied to XLA compilation and its cost analysis;
they wait for the port's kernel-build cache and device telemetry (ROADMAP.md
Queue 1 item 7, step 6).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cruise_control_torch.analyzer.acceptance import empty_tables
from cruise_control_torch.analyzer.actions import KIND_MOVE
from cruise_control_torch.analyzer.bulk import make_bulk_count_round
from cruise_control_torch.analyzer.context import (
    Dims,
    OptimizationOptions,
    build_static_ctx,
    compute_aggregates,
    dims_of,
    make_touch_tag,
    replicas_on_dead,
    resolve_options,
)
from cruise_control_torch.analyzer.drain import (
    make_drain_round,
    make_leadership_relay_round,
    make_pair_drain_round,
    make_topic_swap_round,
    round_jitter,
    table_demoted_pref,
    top_k,
)
from cruise_control_torch.analyzer.goals import (
    DEFAULT_GOAL_ORDER,
    KAFKA_ASSIGNER_GOALS,
    goals_by_priority,
)
from cruise_control_torch.analyzer.goals.base import SCORE_EPS
from cruise_control_torch.analyzer.proposals import ExecutionProposal, proposal_diff
from cruise_control_torch.analyzer.provenance import LEDGER, build_run_ledger, new_run_id
from cruise_control_torch.analyzer.stats import (
    ClusterModelStats,
    compute_stats,
    stats_to_dict,
    stats_to_host,
)
from cruise_control_torch.analyzer.swaps import make_swap_round
from cruise_control_torch.common.history import HISTORY
from cruise_control_torch.common.sensors import REGISTRY
from cruise_control_torch.common.tracing import TRACER, maybe_profile
from cruise_control_torch.config.balancing import BalancingConstraint
from cruise_control_torch.kernels.apply_wave import apply_wave
from cruise_control_torch.kernels.grid_shortlist import grid_shortlist
from cruise_control_torch.kernels.score_candidates import ScoreContext, score_candidates
from cruise_control_torch.kernels.state_fingerprint import state_fingerprint
from cruise_control_torch.models.flat_model import FlatClusterModel
from cruise_control_torch.parallel.sharding import (
    geom_bucket,
    pad_brokers_to,
    pad_partitions_to,
    partition_bucket,
)


class OptimizationFailureException(Exception):
    """A hard goal could not be satisfied (reference:
    com.linkedin.kafka.cruisecontrol.exception.OptimizationFailureException)."""


@dataclasses.dataclass(frozen=True)
class OptimizerSettings:
    """Tuning knobs, with the JAX package's names and defaults (the fields the
    port reads)."""

    batch_k: int = 64
    max_rounds_per_goal: int = 64
    #: > 0: a goal's round cap is clip(ceil(cost_scaled_rounds * entry cost),
    #: max_rounds_per_goal, rounds_ceiling), the cost divided first by the
    #: entry violated-broker count where the bulk planner runs
    cost_scaled_rounds: float = 0.0
    rounds_ceiling: int = 8192
    #: the batch_k=1 grid's rack-representative destination brokers
    num_dst_candidates: int = 16
    num_swap_pairs: int = 8
    swap_candidates: int = 8
    swaps_per_broker: int = 4
    #: pad the partition and topic axes up the eighth-octave ladder
    #: (parallel.sharding.partition_bucket)
    bucket_partitions: bool = True
    #: pad the broker, host and rack axes up the geometric ladder of
    #: `bucket_ratio` steps, exact up to `bucket_floor`; padded brokers are
    #: invalid (zero capacity, neither alive nor dead)
    bucket_brokers: bool = True
    bucket_ratio: float = 1.25
    bucket_floor: int = 64
    chunk_rounds: int = 0
    #: chunked mode: the target wall time of a machine call, from which later
    #: calls' budgets follow the measured round rate. Where a goal's window,
    #: re-derived at each call's entry, moves by an ulp, decisions depend on
    #: where the calls end, and so on the clock (ROADMAP.md Queue 3); a huge
    #: target makes the schedule 8x per call, whatever the clock says
    chunk_target_s: float = 10.0
    apply_waves: int = 8
    drain_src: int = 512
    drain_per_broker: int = 8
    drain_dst: int = 64
    bulk_waves: int = 16
    bulk_min_brokers: int = 32
    polish_rounds: int = 0
    ledger: bool = True

    @classmethod
    def from_config(cls, config) -> "OptimizerSettings":
        """The service's settings from the `optimizer.*` keys (the other
        fields keep their defaults)."""
        return cls(
            batch_k=config.get_int("optimizer.batch.actions.per.round"),
            max_rounds_per_goal=config.get_int("optimizer.max.rounds.per.goal"),
            num_dst_candidates=config.get_int("optimizer.candidate.replicas.per.broker"),
            num_swap_pairs=config.get_int("optimizer.swap.broker.pairs"),
            swap_candidates=config.get_int("optimizer.swap.candidate.replicas"),
            chunk_rounds=config.get_int("optimizer.chunk.rounds"),
            apply_waves=config.get_int("optimizer.apply.waves"),
            drain_src=config.get_int("optimizer.drain.source.brokers"),
            drain_per_broker=config.get_int("optimizer.drain.candidates.per.broker"),
            drain_dst=config.get_int("optimizer.drain.destination.brokers"),
            bulk_waves=config.get_int("optimizer.bulk.count.waves"),
            bulk_min_brokers=config.get_int("optimizer.bulk.min.brokers"),
            polish_rounds=config.get_int("optimizer.polish.rounds"),
            bucket_partitions=config.get_boolean("optimizer.bucket.partitions"),
            bucket_brokers=config.get_boolean("optimizer.bucket.brokers"),
            bucket_ratio=config.get_double("optimizer.bucket.ratio"),
            bucket_floor=config.get_int("optimizer.bucket.floor"),
            ledger=config.get_boolean("optimizer.provenance.ledger"),
        )


#: The hard-goal slice's settings: the service defaults on the fused stack
#: without the bulk planner, shape bucketing or the provenance ledger.
SLICE_SETTINGS = OptimizerSettings(
    batch_k=16, max_rounds_per_goal=64, drain_src=512,
    drain_per_broker=8, drain_dst=64, apply_waves=8, bulk_waves=0, polish_rounds=0,
    chunk_rounds=0, bucket_partitions=False, bucket_brokers=False, ledger=False,
)

#: The full stack's settings: the service defaults (cruise_config.py:102-130)
#: on the fused stack, bulk planner and swaps included, without shape
#: bucketing or the provenance ledger.
STACK_SETTINGS = dataclasses.replace(SLICE_SETTINGS, bulk_waves=16, bulk_min_brokers=32,
                                     num_swap_pairs=8, swap_candidates=8, swaps_per_broker=4)

#: STACK_SETTINGS through the chunked goal machine (`optimizer.chunk.rounds`
#: = 32, cruise_config.py:112) with the provenance ledger
#: (`optimizer.provenance.ledger`, cruise_config.py:426), at the exact shape:
#: the service defaults but shape bucketing.
SERVICE_EXACT_SETTINGS = dataclasses.replace(STACK_SETTINGS, chunk_rounds=32, ledger=True)

#: What the service runs: its defaults, shape bucketing on
#: (`optimizer.bucket.partitions` / `.brokers`, ratio 1.25, floor 64).
SERVICE_SETTINGS = dataclasses.replace(SERVICE_EXACT_SETTINGS, bucket_partitions=True,
                                       bucket_brokers=True)

#: The bench's batched pass (bench.py:215-227 at its defaults: 128 rounds a
#: goal, swaps 16x16x4, chunk 16, 48 polish rounds) at the exact shape (the
#: JAX package's bucketed and exact-shape runs of config 5 differ: ROADMAP.md
#: Queue 3).
BENCH_SETTINGS = OptimizerSettings(
    batch_k=1024, max_rounds_per_goal=128, num_dst_candidates=16, num_swap_pairs=16,
    swap_candidates=16, swaps_per_broker=4, chunk_rounds=16, polish_rounds=48,
    bucket_partitions=False, bucket_brokers=False,
)

#: bench.py's default batched pass: BENCH_SETTINGS with shape bucketing.
BENCH_BUCKETED_SETTINGS = dataclasses.replace(BENCH_SETTINGS, bucket_partitions=True,
                                              bucket_brokers=True)

#: The bench's faithful-greedy parity pass (bench.py:242-248 at its defaults:
#: batch_k=1, cost-scaled caps of 1.5 rounds per cost unit up to 4,096, chunk
#: 64), without shape bucketing.
GREEDY_SETTINGS = OptimizerSettings(
    batch_k=1, max_rounds_per_goal=512, num_dst_candidates=16, num_swap_pairs=16,
    swap_candidates=16, swaps_per_broker=4, chunk_rounds=64, cost_scaled_rounds=1.5,
    rounds_ceiling=4096, bucket_partitions=False, bucket_brokers=False,
)


def _use_bulk(goal, dims: Dims, settings: OptimizerSettings) -> bool:
    return (settings.bulk_waves > 0 and dims.num_brokers >= settings.bulk_min_brokers
            and goal.count_family)


def _use_drain(goal, dims: Dims, settings: OptimizerSettings) -> bool:
    """Whether the goal runs the drain engine rather than the batch_k=1 grid
    (optimizer.py:541-545)."""
    return (settings.batch_k > 1 or goal.uses_swaps
            or (_use_bulk(goal, dims, settings) and goal.pair_drain))


def goal_engine(goal, dims: Dims, settings: OptimizerSettings) -> str:
    """Which search engine a goal runs under these settings/dims (the JAX
    package's labels, optimizer.py:254)."""
    use_bulk = _use_bulk(goal, dims, settings)
    engine = "drain" if _use_drain(goal, dims, settings) else "grid"
    if use_bulk:
        engine = f"bulk+{engine}"
    if settings.polish_rounds > 0:
        engine += "+polish"
    return engine


def check_supported(goals, settings: OptimizerSettings, options: OptimizationOptions) -> None:
    """Refuse what the JAX package refuses: a goal list that mixes the
    kafka-assigner goals with regular ones (goals/__init__.py:78-83, the
    ValueError `goals_by_priority` raises for such names). Every option and
    every setting of OptimizerSettings is ported."""
    assigner = {g.name for g in KAFKA_ASSIGNER_GOALS}
    regular = sorted(g.name for g in goals if g.name not in assigner)
    if regular and len(regular) < len(goals):
        raise ValueError(f"cannot mix kafka-assigner and regular goals: {regular}")


def bucket_label(dims: Dims) -> str:
    """The shape bucket's name (optimizer.py:1282): the padded axis sizes."""
    return f"P{dims.num_partitions}-B{dims.num_brokers}-T{dims.num_topics}-RF{dims.max_rf}"


def _swap_width(num_brokers: int, num_swap_pairs: int) -> int:
    """The swap round's hot/cold width (optimizer.py:612-614): a sixteenth
    of the brokers, up to the next power of two, within [num_swap_pairs,
    128]; 128 at 2,600 brokers."""
    width = num_brokers // 16
    width = 1 << max(0, width - 1).bit_length() if width > 1 else width
    return max(num_swap_pairs, min(128, width))


def dst_candidates(static, gs, agg, goal, dims: Dims, k: int, tables=None) -> torch.Tensor:
    """i32[min(k, NR)]: the best eligible broker of each of the top-k racks by
    the goal's table-demoted destination preference (optimizer.py:303-321):
    a first-index argmax per rack, the racks ranked with ties to the lowest
    index. A rack with no eligible broker falls back to the best rack's
    candidate, a duplicate column that is inert in the grid."""
    pref = table_demoted_pref(static, gs, agg, goal, tables)
    nr = dims.num_racks
    dev = pref.device
    neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
    rack_mask = static.broker_rack[None, :] == torch.arange(nr, device=dev)[:, None]
    per_rack = torch.where(rack_mask, pref[None, :], neg_inf)
    best_broker = torch.argmax(per_rack, dim=1).to(torch.int32)
    vals, rack_idx = top_k(torch.amax(per_rack, dim=1), min(k, nr))
    cands = best_broker[rack_idx]
    return torch.where(torch.isfinite(vals), cands, cands[0])


def _scaled_cap(cost, violated, use_bulk: bool, floor: int, settings: OptimizerSettings) -> int:
    """A goal's cost-scaled round cap (optimizer.py:644-667, :1000-1023), in
    float32 as the JAX code computes it: ceil(cost_scaled_rounds * cost),
    the cost divided first by max(1, violated) where the bulk planner runs,
    clipped to [floor, rounds_ceiling] in float before the int cast."""
    dev = cost.device
    scale = cost.to(torch.float32)
    if use_bulk:
        scale = scale / torch.clamp(violated.to(torch.float32), min=1.0)
    f32 = dict(dtype=torch.float32, device=dev)
    scaled = torch.clamp(torch.ceil(torch.tensor(settings.cost_scaled_rounds, **f32) * scale),
                         torch.tensor(float(floor), **f32),
                         torch.tensor(float(settings.rounds_ceiling), **f32))
    return int(scaled.to(torch.int32))


def _make_grid_round(goal, dims: Dims, settings: OptimizerSettings):
    """one_round(static, agg, tables, rnd) -> (agg, applied): the batch_k=1
    greedy round (optimizer.py:357-520). K9 gives the shortlist (the best
    action over the [P, R, K] move grid and the [P, R-1] leadership grid);
    unless the round is the faithful greedy's (one entry, a goal with moves),
    `apply_waves` waves re-score it (K3) and apply it (K4), toward
    rank-paired destinations for moves and wherever the promoted replica
    lives for promotions; then, for goals with moves, the precision wave
    scores the entry against every broker (K3) and applies it toward the
    first best. `agg` is updated in place; `applied` is a bool device
    tensor."""
    p_count = dims.num_partitions
    k_dst = max(1, min(settings.num_dst_candidates, dims.num_racks))
    k_sel = max(1, min(settings.batch_k, p_count))
    n_waves = max(1, settings.apply_waves)

    def one_round(static, agg, tables, rnd: int):
        dev = agg.assignment.device
        gs = goal.prepare(static, agg, dims)
        cands = dst_candidates(static, gs, agg, goal, dims, k_dst, tables)
        ctx = ScoreContext(static, agg, tables, goal, gs)
        top_scores, sel_p, sel_kind, sel_slot, sel_dst0 = grid_shortlist(
            static, agg, tables, goal, gs, cands, k_sel, ctx=ctx)
        live = torch.isfinite(top_scores)
        is_move = sel_kind == KIND_MOVE
        applied = torch.zeros((), dtype=torch.bool, device=dev)
        done = torch.zeros(k_sel, dtype=torch.bool, device=dev)

        def lead_dst():
            return agg.assignment[sel_p.long(), sel_slot.long()]

        def wave_with_dst(fresh_dst, w: int):
            nonlocal applied, done
            fresh_dst = fresh_dst.to(torch.int32).contiguous()
            s = score_candidates(static, agg, tables, goal, gs, sel_p, sel_kind, sel_slot,
                                 fresh_dst, ctx=ctx)
            sel = apply_wave(static, agg, sel_p, sel_kind, sel_slot, fresh_dst, s,
                             torch.isfinite(s) & live & ~done, make_touch_tag(rnd, w))
            applied = applied | torch.any(sel)
            done = done | sel

        if not (k_sel == 1 and goal.uses_moves):
            for w in range(n_waves):
                if goal.uses_moves:
                    pref = table_demoted_pref(static, gs, agg, goal, tables)
                    dst_rank = torch.argsort(-pref, stable=True).to(torch.int32)
                    # only move entries consume destination ranks, wrapped
                    # over the feasible prefix
                    r = torch.cumsum((~done & live & is_move).to(torch.int32), dim=0) - 1
                    n_feasible = torch.clamp(torch.sum(torch.isfinite(pref)), min=1)
                    fresh = torch.where(is_move, dst_rank[((r + w) % n_feasible).long()],
                                        lead_dst())
                else:
                    fresh = torch.where(is_move, sel_dst0, lead_dst())
                wave_with_dst(fresh, w)
        if goal.uses_moves:
            all_brokers = torch.arange(dims.num_brokers, dtype=torch.int32, device=dev)
            s_b = score_candidates(static, agg, tables, goal, gs, sel_p[:, None],
                                   sel_kind[:, None], sel_slot[:, None], all_brokers[None, :],
                                   ctx=ctx)
            best = torch.argmax(s_b, dim=1).to(torch.int32)
            wave_with_dst(torch.where(is_move, best, lead_dst()), n_waves)
        return agg, applied

    return one_round


def _make_goal_loop(goal, dims: Dims, settings: OptimizerSettings):
    """goal_loop(static, agg, tables, budget, rnd_base, empties0, stall_at)
    -> (agg, rounds, empties): rounds until the goal stalls or `budget` more
    rounds ran (optimizer.py:536-775); `agg` is updated in place. Each round:
    the bulk planner first (count goals), then, when it applied nothing, the
    goal's engine (the drain round, or the batch_k=1 grid), then its stall
    fallbacks (swaps, topic swaps, relays) only while nothing has applied.
    `rnd_base` and `empties0` resume a goal paused by the chunked machine:
    the absolute round index seeds the round jitter and the touch tags, and
    the empty-round streak carries over. Without a `budget` the cap is
    max_rounds_per_goal, or the cost-scaled cap."""
    use_bulk = _use_bulk(goal, dims, settings)
    use_drain = _use_drain(goal, dims, settings)
    bulk_fn = None
    if use_bulk and not goal.pair_drain:
        bulk_fn = make_bulk_count_round(goal, dims, settings.drain_per_broker, settings.bulk_waves)
    drain_fn = grid_fn = topic_swap_fn = lead_swap_fn = swap_fn = None
    if not use_drain:
        grid_fn = _make_grid_round(goal, dims, settings)
    elif goal.pair_drain:
        drain_fn = make_pair_drain_round(goal, dims, settings.drain_src, settings.apply_waves)
        topic_swap_fn = make_topic_swap_round(goal, dims, settings.drain_src,
                                              max(4, settings.drain_dst // 4), 8,
                                              settings.apply_waves)
    else:
        drain_fn = make_drain_round(goal, dims, settings.drain_src, settings.drain_per_broker,
                                    settings.drain_dst, settings.apply_waves)
    if goal.leadership_swap and dims.max_rf >= 2:
        lead_swap_fn = make_leadership_relay_round(goal, dims, settings.drain_src, 4, 8,
                                                   settings.apply_waves)
    if goal.uses_swaps:
        swap_fn = make_swap_round(goal, dims, _swap_width(dims.num_brokers, settings.num_swap_pairs),
                                  settings.swap_candidates, settings.swaps_per_broker,
                                  settings.apply_waves)
    rotated = goal.pair_drain or goal.rotate_drain_candidates
    empties_to_stall = 8 if rotated else 1

    def engine(static, agg, tables, gs0, rnd: int):
        contrib = None
        if grid_fn is not None:
            agg, applied = grid_fn(static, agg, tables, rnd)
        else:
            contrib = goal.drain_contrib(static, gs0, agg)
            if goal.rotate_drain_candidates:
                contrib = contrib * round_jitter(contrib.shape[0], rnd, contrib.device)[:, None]
            agg, applied = drain_fn(static, agg, tables, gs0, contrib, rnd)
        # the fallbacks run only after a round that applied nothing, on the
        # round's unchanged aggregates
        for fallback in (swap_fn, topic_swap_fn, lead_swap_fn):
            if fallback is None or bool(applied):
                continue
            if fallback is swap_fn:
                agg, applied = fallback(static, agg, tables, contrib, rnd)
            else:
                agg, applied = fallback(static, agg, tables, gs0, rnd)
        return agg, applied

    def goal_loop(static, agg, tables, budget: Optional[int] = None, rnd_base: int = 0,
                  empties0: int = 0, stall_at: Optional[int] = None):
        # the window is re-derived on every entry, as the JAX loop does (:641)
        gs0 = goal.prepare(static, agg, dims)
        if budget is None:
            budget = settings.max_rounds_per_goal
            if settings.cost_scaled_rounds > 0:
                budget = _scaled_cap(goal.cost(static, gs0, agg),
                                     _violated(goal, static, gs0, agg), use_bulk, budget,
                                     settings)
        if stall_at is None:
            stall_at = empties_to_stall
        rnd, empties = rnd_base, empties0
        while rnd - rnd_base < budget and empties < stall_at:
            applied = False
            if bulk_fn is not None:
                agg, applied = bulk_fn(static, agg, tables, gs0,
                                       goal.drain_contrib(static, gs0, agg), rnd)
            if not applied:
                agg, applied = engine(static, agg, tables, gs0, rnd)
            # a zero-cost goal with no dead-broker replicas left is done
            satisfied = (goal.cost(static, gs0, agg) <= SCORE_EPS) & ~torch.any(
                replicas_on_dead(static, agg.assignment))
            state = torch.stack([satisfied, torch.as_tensor(applied, device=satisfied.device)])
            satisfied, applied = (bool(x) for x in state.cpu())
            empties = empties_to_stall if satisfied else (0 if applied else empties + 1)
            rnd += 1
        return agg, rnd - rnd_base, empties

    goal_loop.empties_to_stall = empties_to_stall
    return goal_loop


class StackMetrics(NamedTuple):
    """Per-goal diagnostics of one stack run; row i = i-th goal. Device
    tensors while the goal machine runs, numpy once the run is over."""

    violated_before: np.ndarray  # i32[G]
    violated_after: np.ndarray  # i32[G]
    cost_before: np.ndarray  # f32[G]
    cost_after: np.ndarray  # f32[G]
    rounds: np.ndarray  # i32[G]
    #: True when the goal stalled rather than exhausting its round cap
    converged: np.ndarray  # bool[G]
    #: the aggregates' fingerprint at the goal's exit (K7; u32, held in
    #: int64 on the device)
    state_fp: np.ndarray  # u32[G]


def empty_stack_metrics(n_goals: int, device) -> StackMetrics:
    """Zeroed device metrics for the goal machine (optimizer.py:1187)."""
    def zeros(dtype):
        return torch.zeros(n_goals, dtype=dtype, device=device)

    return StackMetrics(zeros(torch.int32), zeros(torch.int32), zeros(torch.float32),
                        zeros(torch.float32), zeros(torch.int32), zeros(torch.bool),
                        zeros(torch.int64))


def _metrics_to_host(metrics: StackMetrics) -> StackMetrics:
    host = [t.cpu().numpy() for t in metrics]
    host[-1] = host[-1].astype(np.uint32)
    return StackMetrics(*host)


def empty_prov_snapshots(n_phases: int, dims: Dims, enabled: bool, device):
    """The machine's per-phase (assignment, touch_tag) snapshot rows
    (optimizer.py:1172); zero rows when the ledger is off."""
    shape = (n_phases if enabled else 0, dims.num_partitions, dims.max_rf)
    return (torch.zeros(shape, dtype=torch.int32, device=device),
            torch.full(shape, -1, dtype=torch.int32, device=device))


def _violated(goal, static, gs, agg) -> torch.Tensor:
    return torch.sum(goal.broker_violation(static, gs, agg)).to(torch.int32)


def measure(goals, dims: Dims, static, agg):
    """(violated i32[G], cost f32[G]) of every goal on the state `agg` (the
    JAX package's _cached_measure, :1246): the final per-goal rows after a
    polish pass, in which a later phase may move an earlier goal's cost
    within its bounds."""
    viol, cost = [], []
    for goal in goals:
        gs = goal.prepare(static, agg, dims)
        viol.append(_violated(goal, static, gs, agg))
        cost.append(goal.cost(static, gs, agg).to(torch.float32))
    return torch.stack(viol), torch.stack(cost)


def _polish_stall(loop) -> int:
    """A polish phase's cheaper stall proof: half the empty-round threshold."""
    return max(1, loop.empties_to_stall // 2)


def _polish_skip(agg, converged: bool, exit_fp) -> bool:
    """A polish phase retries a goal only when it stopped on its round cap or
    the state changed since its exit (K7's fingerprint, optimizer.py:1035)."""
    return converged and int(state_fingerprint(agg)) == int(exit_fp)


def run_stack(goals, dims: Dims, settings: OptimizerSettings, static, agg):
    """Run the priority-ordered goal stack (the JAX package's
    _make_stack_step, :823-889): each goal's loop feeds the next, and each
    finished goal contributes its bounds to the merged acceptance tables.
    With `polish_rounds`, a second pass re-runs each goal under the full
    tables (:848-878): skipped when the goal converged and the state is
    still its exit state, at most `polish_rounds` rounds with half the
    stall threshold otherwise; the rounds add up, and every goal's after-row
    is re-measured at the end. With the ledger on, the assignment and touch
    tags are snapshotted after each phase. Returns (agg, StackMetrics,
    snapshots or None), on the host."""
    tables = empty_tables(dims, agg.assignment.device)
    loops = [_make_goal_loop(goal, dims, settings) for goal in goals]
    vb, va, cb, ca, rs, cv, fps, snaps_a, snaps_t = [], [], [], [], [], [], [], [], []

    def snapshot():
        if settings.ledger:
            snaps_a.append(agg.assignment.clone())
            snaps_t.append(agg.touch_tag.clone())

    for goal, loop in zip(goals, loops):
        gs0 = goal.prepare(static, agg, dims)
        vb.append(_violated(goal, static, gs0, agg))
        cb.append(goal.cost(static, gs0, agg).to(torch.float32))
        agg, rounds, empties = loop(static, agg, tables)
        gs1 = goal.prepare(static, agg, dims)
        va.append(_violated(goal, static, gs1, agg))
        ca.append(goal.cost(static, gs1, agg).to(torch.float32))
        rs.append(rounds)
        cv.append(empties >= loop.empties_to_stall)
        fps.append(state_fingerprint(agg))
        tables = goal.contribute_acceptance(static, gs1, tables)
        snapshot()
    if settings.polish_rounds > 0:
        for i, loop in enumerate(loops):
            skip = _polish_skip(agg, cv[i], fps[i])
            stall = _polish_stall(loop)
            agg, rounds, empties = loop(static, agg, tables,
                                        0 if skip else settings.polish_rounds, stall_at=stall)
            rs[i] += rounds
            cv[i] = cv[i] if skip else empties >= stall
            fps[i] = state_fingerprint(agg)
            snapshot()
        viol, cost = measure(goals, dims, static, agg)
        va, ca = list(viol), list(cost)
    metrics = StackMetrics(
        violated_before=torch.stack(vb).cpu().numpy(),
        violated_after=torch.stack(va).cpu().numpy(),
        cost_before=torch.stack(cb).cpu().numpy(),
        cost_after=torch.stack(ca).cpu().numpy(),
        rounds=np.asarray(rs, dtype=np.int32),
        converged=np.asarray(cv, dtype=bool),
        state_fp=torch.stack(fps).cpu().numpy().astype(np.uint32),
    )
    prov = None
    if settings.ledger:
        prov = (torch.stack(snaps_a).cpu().numpy(), torch.stack(snaps_t).cpu().numpy())
    return agg, metrics, prov


def _make_goal_machine(goals, dims: Dims, settings: OptimizerSettings):
    """The chunked goal machine (optimizer.py:911-1170) as a host function:

        machine(static, agg, tables, phase, rounds_in_goal, empties_in_goal,
                metrics, budget, enabled, snap)
          -> (agg, tables, phase, rounds_in_goal, empties_in_goal, metrics,
              spent, snap)

    advances the stack by up to `budget` rounds, crossing goal boundaries.
    Phases 0..G-1 run the goals; with `polish_rounds`, phases G..2G-1 re-run
    goal g = phase - G under the full tables (:964-971). A goal's entry row
    (violated_before, cost_before) is written the first time its main phase
    runs; its exit row, state fingerprint included, at every pause or exit;
    its tables when its main phase is done (stalled, or its round cap
    reached); the phase's snapshot row then. The round cap is
    max_rounds_per_goal, or the cost-scaled cap of the goal's entry row; a
    polish phase's is `polish_rounds`, or 0 when it is skipped (the goal
    converged and the state is its exit state), and it stalls at half the
    threshold, adds its rounds to the goal's, and keeps the goal's converged
    flag when skipped (:1000-1092). A disabled goal (`enabled[g]` False)
    advances the cursor with no rounds, no tables and untouched metrics
    rows, and writes its snapshot row from the unchanged state (skip_branch,
    :1107-1121). `metrics` and `snap` are updated in place; the cursor is
    host ints."""
    loops = [_make_goal_loop(g, dims, settings) for g in goals]
    n_goals = len(goals)
    n_phases = 2 * n_goals if settings.polish_rounds > 0 else n_goals

    def machine(static, agg, tables, phase: int, rounds_in_goal: int, empties_in_goal: int,
                metrics: StackMetrics, budget: int, enabled, snap):
        gi, rig, emp, left = phase, rounds_in_goal, empties_in_goal, budget
        snap_a, snap_t = snap

        def snapshot(row):
            if snap_a.shape[0]:
                snap_a[row].copy_(agg.assignment)
                snap_t[row].copy_(agg.touch_tag)

        while left > 0 and gi < n_phases:
            polishing = gi >= n_goals
            g = gi - n_goals if polishing else gi
            goal, loop = goals[g], loops[g]
            if not enabled[g]:
                snapshot(gi)
                gi, rig, emp = gi + 1, 0, 0
                continue
            if rig == 0 and not polishing:
                # the JAX machine measures the entry state on every entry and
                # records it on the first only (:986-1000)
                gs_in = goal.prepare(static, agg, dims)
                metrics.violated_before[g] = _violated(goal, static, gs_in, agg)
                metrics.cost_before[g] = goal.cost(static, gs_in, agg)
            skip, stall = False, loop.empties_to_stall
            if polishing:
                skip = _polish_skip(agg, bool(metrics.converged[g]), metrics.state_fp[g])
                cap, stall = (0 if skip else settings.polish_rounds), _polish_stall(loop)
            elif settings.cost_scaled_rounds > 0:
                cap = _scaled_cap(metrics.cost_before[g], metrics.violated_before[g],
                                  _use_bulk(goal, dims, settings), settings.max_rounds_per_goal,
                                  settings)
            else:
                cap = settings.max_rounds_per_goal
            agg, rounds, emp2 = loop(static, agg, tables, min(left, cap - rig), rnd_base=rig,
                                     empties0=emp, stall_at=stall)
            rig2 = rig + rounds
            stalled = bool(metrics.converged[g]) if skip else emp2 >= stall
            done = stalled or rig2 >= cap
            gs_out = goal.prepare(static, agg, dims)
            metrics.violated_after[g] = _violated(goal, static, gs_out, agg)
            metrics.cost_after[g] = goal.cost(static, gs_out, agg)
            if polishing:
                metrics.rounds[g] += rounds
            else:
                metrics.rounds[g] = rig2
            metrics.converged[g] = stalled
            metrics.state_fp[g] = state_fingerprint(agg)
            left -= rounds
            if done:
                if not polishing:
                    tables = goal.contribute_acceptance(static, gs_out, tables)
                snapshot(gi)
                gi, rig, emp = gi + 1, 0, 0
            else:
                rig, emp = rig2, emp2
        return agg, tables, gi, rig, emp, metrics, budget - left, snap

    machine.n_phases = n_phases
    return machine


def _machine_goal_plan(requested: Sequence[str]):
    """(machine_names, enabled, rows) (optimizer.py:1402): any subset of the
    default stack runs through the full-stack machine with the runtime
    `enabled` mask, and the requested goals' rows are selected back out."""
    default_names = tuple(g.name for g in DEFAULT_GOAL_ORDER)
    requested = tuple(requested)
    machine_names = default_names if set(requested) <= set(default_names) else requested
    enabled = np.array([n in requested for n in machine_names])
    rows = np.array([machine_names.index(n) for n in requested], dtype=np.int64)
    return machine_names, enabled, rows


@dataclasses.dataclass
class GoalResult:
    """Per-goal outcome, the analog of GoalOptimizer's per-goal stats snapshot."""

    name: str
    is_hard: bool
    violated_brokers_before: int
    violated_brokers_after: int
    cost_before: float
    cost_after: float
    rounds: int
    duration_s: float
    converged: bool = True


@dataclasses.dataclass
class OptimizerResult:
    """The analog of GoalOptimizer.OptimizerResult (GoalOptimizer.java:537)."""

    proposals: List[ExecutionProposal]
    goal_results: List[GoalResult]
    stats_before: ClusterModelStats
    stats_after: ClusterModelStats
    final_assignment: np.ndarray
    num_replica_moves: int
    num_leadership_moves: int
    data_to_move_mb: float
    duration_s: float
    #: the final touch tags i32[P, R] (packed round/wave of each cell's last write)
    touch_tag: Optional[np.ndarray] = None
    #: the run's decision-provenance ledger (analyzer/provenance.py
    #: RunLedger), also recorded in provenance.LEDGER; None with the ledger off
    provenance: Optional[object] = None
    #: the exact and padded shapes (`exact`, `padded`, `bucket`,
    #: `paddedPartitions`, `paddedBrokers`; `incremental` on a lane solve)
    bucketed: Optional[dict] = None
    #: drift-safety stamps (executor/validation.py), set at model-build time
    #: by whoever built the model from the monitor: the monitor generation
    #: and the topology fingerprint (broker set + alive mask + per-topic
    #: partition counts); the executor revalidates against them before and
    #: during dispatch. None when the result was computed on a caller model.
    generation: Optional[int] = None
    fingerprint: Optional[object] = None

    @property
    def violated_goals_before(self) -> List[str]:
        return [g.name for g in self.goal_results if g.violated_brokers_before]

    @property
    def violated_goals_after(self) -> List[str]:
        return [g.name for g in self.goal_results if g.violated_brokers_after]

    def summary(self) -> Dict:
        """Movement + stats summary (OptimizerResult.getProposalSummary analog)."""
        stamp = None
        if self.generation is not None or self.fingerprint is not None:
            stamp = {
                "generation": self.generation,
                "fingerprint": (
                    self.fingerprint.to_dict() if self.fingerprint is not None else None
                ),
            }
        prov = None
        if self.provenance is not None:
            prov = {
                "runId": self.provenance.run_id,
                "digest": self.provenance.digest(),
            }
        return {
            **({"proposalStamp": stamp} if stamp else {}),
            **({"provenance": prov} if prov else {}),
            "numReplicaMovements": self.num_replica_moves,
            "numLeaderMovements": self.num_leadership_moves,
            "dataToMoveMB": round(self.data_to_move_mb, 3),
            "numProposals": len(self.proposals),
            "violatedGoalsBefore": self.violated_goals_before,
            "violatedGoalsAfter": self.violated_goals_after,
            "onDemandBalancednessScoreBefore": stats_to_dict(self.stats_before),
            "onDemandBalancednessScoreAfter": stats_to_dict(self.stats_after),
            "goals": [
                {
                    "goal": g.name,
                    "hard": g.is_hard,
                    "violatedBrokersBefore": g.violated_brokers_before,
                    "violatedBrokersAfter": g.violated_brokers_after,
                    "costBefore": g.cost_before,
                    "costAfter": g.cost_after,
                    "rounds": g.rounds,
                    "converged": g.converged,
                    "durationS": round(g.duration_s, 4),
                }
                for g in self.goal_results
            ],
            "durationS": round(self.duration_s, 4),
        }


#: entries of the prep cache (the JAX package's two-entry LRU)
_PREP_CACHE_SIZE = 2


class GoalOptimizer:
    """Runs goals in priority order against one flattened cluster model, on
    `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, constraint: Optional[BalancingConstraint] = None,
                 settings: OptimizerSettings = SLICE_SETTINGS, device="cuda"):
        self._constraint = constraint or BalancingConstraint.default()
        self._settings = settings
        self._device = torch.device(device)
        #: _prepare_key -> (p_orig, pmodel, dims, static, static_canon,
        #: bucketed, model, options); the last two pin the key's objects
        self._prep_cache: "collections.OrderedDict" = collections.OrderedDict()

    # -- the front half: pad, bucket, build the static context ---------------

    def _prepare(self, model: FlatClusterModel, goal_names: Optional[Sequence[str]],
                 options: OptimizationOptions):
        """(goals, p_orig, padded model, dims, static, agg, bucketed)
        (optimizer.py:1655). The padded model and static context come from
        the prep cache when the caller passes the same model tensors and
        options again; the aggregates are computed anew, since the solve
        writes them in place."""
        goals = goals_by_priority(goal_names)
        check_supported(goals, self._settings, options)
        key = self._prepare_key(model, options)
        hit = self._prep_cache.get(key)
        if hit is not None:
            self._prep_cache.move_to_end(key)
            REGISTRY.meter("GoalOptimizer.static-ctx-cache-hits").mark()
        else:
            REGISTRY.meter("GoalOptimizer.static-ctx-cache-misses").mark()
            hit = (*self._build_ctx(model, options), model, options)
            self._prep_cache[key] = hit
            while len(self._prep_cache) > _PREP_CACHE_SIZE:
                self._prep_cache.popitem(last=False)
        p_orig, pmodel, dims, static, static_canon, bucketed = hit[:6]
        agg = self._initial_aggregates(pmodel, dims, static, static_canon)
        return goals, p_orig, pmodel, dims, static, agg, bucketed

    def _initial_aggregates(self, pmodel: FlatClusterModel, dims: Dims, static, static_canon):
        """K1 on the padded model's assignment (optimizer.py:1693), shared by
        `_prepare` and the incremental lane. There is no mesh, so the
        canonical context is the context."""
        return compute_aggregates(static_canon, pmodel.assignment, dims)

    def prepared_entry(self, model: FlatClusterModel, options: OptimizationOptions):
        """(p_orig, pmodel, dims, static, static_canon, bucketed) of the prep
        cache's entry for (model, options), or None (optimizer.py:1714): the
        incremental lane's seam."""
        hit = self._prep_cache.get(self._prepare_key(model, options))
        return None if hit is None else hit[:6]

    @staticmethod
    def _prepare_key(model: FlatClusterModel, options: OptimizationOptions):
        """The identity of the model's tensors and the options' contents
        (optimizer.py:1726): array fields by object identity (the entry holds
        the objects, so a live id cannot alias a new one), scalar and tuple
        fields by value. Take it on the caller's model, before any copy."""

        def kid(v):
            return ("id", id(v)) if v is not None and not isinstance(
                v, (bool, int, float, str, tuple)) else v

        return tuple(id(f) for f in model) + tuple(
            kid(getattr(options, f.name)) for f in dataclasses.fields(options))

    def _build_ctx(self, model: FlatClusterModel,
                   options: OptimizationOptions = OptimizationOptions()):
        """The prep cache's miss path (optimizer.py:1742-1858): resolve the
        options' broker ids (a topic pattern needs the caller's topic names,
        so `resolve_options` raises for it here, as in the JAX package),
        bucket every axis up its ladder, pad the model on the host with the
        option masks (padded partitions excluded, padded brokers in no
        broker mask), move it to the device once and build the static
        context with the real counts. Returns (p_orig, pmodel, dims, static,
        static_canon, bucketed)."""
        s = self._settings
        host = model.to("cpu")
        if options.destination_broker_ids is not None or options.excluded_topic_pattern is not None:
            options = resolve_options(options, host)
        p_orig, b_orig = host.num_partitions, host.num_brokers
        exact = dims_of(host)
        target_p = partition_bucket(p_orig) if s.bucket_partitions else p_orig
        host = pad_partitions_to(host, target_p)
        if target_p != p_orig and options.excluded_partitions is not None:
            options = dataclasses.replace(options, excluded_partitions=np.concatenate(
                [np.asarray(options.excluded_partitions, dtype=bool),
                 np.ones(target_p - p_orig, dtype=bool)]))
        num_topics = partition_bucket(exact.num_topics) if s.bucket_partitions else exact.num_topics
        num_racks, num_hosts, target_b = exact.num_racks, exact.num_hosts, b_orig
        if s.bucket_brokers:
            target_b = geom_bucket(b_orig, s.bucket_ratio, s.bucket_floor)
            num_racks = geom_bucket(exact.num_racks, s.bucket_ratio, s.bucket_floor)
            num_hosts = geom_bucket(exact.num_hosts, s.bucket_ratio, s.bucket_floor)
            host = pad_brokers_to(host, target_b, num_racks, num_hosts)

            def pad_mask(arr):
                return None if arr is None else np.concatenate(
                    [np.asarray(arr, dtype=bool), np.zeros(target_b - b_orig, dtype=bool)])

            options = dataclasses.replace(
                options,
                excluded_brokers_for_leadership=pad_mask(options.excluded_brokers_for_leadership),
                excluded_brokers_for_replica_move=pad_mask(
                    options.excluded_brokers_for_replica_move),
                requested_destination_brokers=pad_mask(options.requested_destination_brokers))
        dims = Dims(num_partitions=host.num_partitions, max_rf=exact.max_rf,
                    num_brokers=target_b, num_racks=num_racks, num_hosts=num_hosts,
                    num_topics=num_topics)
        pmodel = host.to(self._device)
        static = build_static_ctx(pmodel, self._constraint, dims, options, valid_brokers=b_orig,
                                  valid_partitions=p_orig)
        bucketed = {
            "exact": dataclasses.asdict(exact),
            "padded": dataclasses.asdict(dims),
            "bucket": bucket_label(dims),
            "paddedPartitions": dims.num_partitions - p_orig,
            "paddedBrokers": dims.num_brokers - b_orig,
        }
        return p_orig, pmodel, dims, static, static, bucketed

    def warmup(self, model: FlatClusterModel, goal_names: Optional[Sequence[str]] = None,
               options: OptimizationOptions = OptimizationOptions()) -> float:
        """Pay the first-use costs outside a timed solve (optimizer.py:1860):
        build the kernels (on the card), prepare the model (the prep cache's
        entry), compute its statistics, then make one budget-1 machine call
        and, with the polish pass, the final re-measure; the fused stack has
        no short call, so it runs whole. Returns the seconds spent."""
        t0 = time.monotonic()
        if self._device.type == "cuda":
            from cruise_control_torch.kernels import build

            build.build_all()
        goals, _, pmodel, dims, static, agg, _ = self._prepare(model, goal_names, options)
        compute_stats(pmodel, dims.num_topics)
        names = tuple(g.name for g in goals)
        if self._settings.chunk_rounds > 0:
            machine_names, enabled, _ = _machine_goal_plan(names)
            machine = _make_goal_machine(goals_by_priority(machine_names), dims, self._settings)
            out = machine(static, agg, empty_tables(dims, agg.assignment.device), 0, 0, 0,
                          empty_stack_metrics(len(machine_names), agg.assignment.device), 1,
                          enabled, empty_prov_snapshots(machine.n_phases, dims,
                                                        self._settings.ledger,
                                                        agg.assignment.device))
            if self._settings.polish_rounds > 0:
                measure(goals_by_priority(machine_names), dims, static, out[0])
        else:
            run_stack(goals, dims, self._settings, static, agg)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return time.monotonic() - t0

    # -- the entry points ------------------------------------------------------

    def optimizations(
        self,
        model: FlatClusterModel,
        goal_names: Optional[Sequence[str]] = None,
        options: OptimizationOptions = OptimizationOptions(),
        raise_on_hard_failure: bool = True,
    ) -> OptimizerResult:
        """Run the requested goal stack and diff initial vs final placement,
        under a `proposal` tracer span (optimizer.py:1951)."""
        with maybe_profile() as profiled, TRACER.span(
                "proposal-computation", kind="proposal", brokers=int(model.num_brokers),
                partitions=int(model.num_partitions), profiled=bool(profiled)) as root:
            t0 = time.monotonic()
            goals, p_orig, pmodel, dims, static, agg, bucketed = self._prepare(
                model, goal_names, options)
            result = self._solve_prepared(goals, p_orig, pmodel, dims, static, agg, bucketed,
                                          raise_on_hard_failure, t0)
            root.attributes.update(numProposals=len(result.proposals),
                                   replicaMoves=result.num_replica_moves,
                                   leadershipMoves=result.num_leadership_moves)
        # a sensor time-series point at the proposal boundary (rate-limited;
        # the point records the registry as this computation left it)
        HISTORY.record_boundary("proposal")
        return result

    def incremental_optimizations(self, pmodel: FlatClusterModel, dims: Dims, static,
                                  static_canon, bucketed, p_orig: int,
                                  goal_names: Optional[Sequence[str]] = None,
                                  raise_on_hard_failure: bool = False) -> OptimizerResult:
        """Solve an already prepared padded model (optimizer.py:1972): the
        incremental lane's entry point. `static` is the lane's delta-updated
        context of the armed bucket, `pmodel` its padded model (host or
        device tensors), `goal_names` the affected subset. Only the initial
        aggregates are computed; the solve is `_solve_prepared`, the code the
        scratch lane runs."""
        with maybe_profile() as profiled, TRACER.span(
                "incremental-proposal", kind="proposal", brokers=int(dims.num_brokers),
                partitions=int(dims.num_partitions),
                goals=len(tuple(goal_names)) if goal_names is not None else -1,
                profiled=bool(profiled)) as root:
            t0 = time.monotonic()
            goals = goals_by_priority(goal_names)
            check_supported(goals, self._settings, OptimizationOptions())
            pmodel = pmodel.to(self._device)
            agg = self._initial_aggregates(pmodel, dims, static, static_canon)
            result = self._solve_prepared(goals, p_orig, pmodel, dims, static, agg, bucketed,
                                          raise_on_hard_failure, t0)
            root.attributes.update(numProposals=len(result.proposals),
                                   replicaMoves=result.num_replica_moves,
                                   leadershipMoves=result.num_leadership_moves)
        HISTORY.record_boundary("proposal")
        return result

    def _run_chunked(self, goals, enabled: np.ndarray, dims: Dims, static, agg):
        """Drive the goal machine (optimizer.py:1553-1653): calls of at most
        `chunk` rounds each, crossing goal (and polish phase) boundaries, then,
        after a polish pass, re-measure every goal's after-row. After each call the
        per-goal round counts are read back once, the call's wall time is
        attributed to goals by their share of its rounds, and the next
        budget follows the measured round rate toward `chunk_target_s` (at
        most 8x the last, back to `chunk_rounds` at a goal boundary). A goal
        re-derives its window when a call resumes it, as the JAX machine
        does, so where the calls end can move a knife-edge decision
        (`chunk_target_s`). Returns (agg, host metrics, stack seconds,
        per-goal seconds, host snapshots or None); rows follow `goals`."""
        s = self._settings
        dev = agg.assignment.device
        n = len(goals)
        tables = empty_tables(dims, dev)
        metrics = empty_stack_metrics(n, dev)
        machine = _make_goal_machine(goals, dims, s)
        snap = empty_prov_snapshots(machine.n_phases, dims, s.ledger, dev)
        gi = rig = emp = 0
        chunk = s.chunk_rounds
        durs = np.zeros(n, np.float64)
        rounds_seen = np.zeros(n, np.int64)
        last_gi = 0
        round_hist = REGISTRY.histogram("GoalOptimizer.optimizer-round-timer")
        call_hist = REGISTRY.histogram("GoalOptimizer.device-call-timer")
        dispatches = REGISTRY.meter("GoalOptimizer.device-dispatches")
        t_stack = time.monotonic()
        while True:
            t_call = time.monotonic()
            # one tracer span a machine call, and a profiler range of the
            # same call, so a capture joins the /trace spans
            with TRACER.span("optimizer.device-call", kind="device-call",
                             goal=goals[min(gi % n, n - 1)].name,
                             phase="polish" if gi >= n else "main",
                             budget=int(max(1, chunk))) as call_span, \
                    torch.profiler.record_function("cc-machine-call"):
                agg, tables, gi, rig, emp, metrics, spent, snap = machine(
                    static, agg, tables, gi, rig, emp, metrics, max(1, chunk), enabled, snap)
                rounds_h = metrics.rounds.cpu().numpy().astype(np.int64)
                call_span.attributes["rounds"] = int(spent)
                call_span.attributes["goalIndexAfter"] = int(gi)
            call_s = time.monotonic() - t_call
            dispatches.mark()
            call_hist.record(call_s)
            if spent > 0:
                # one sample a call of its mean round time
                round_hist.record(call_s / spent)
            delta = np.maximum(rounds_h - rounds_seen, 0)
            if delta.sum() > 0:
                durs += call_s * delta / delta.sum()
            rounds_seen = np.maximum(rounds_seen, rounds_h)
            if gi >= machine.n_phases:
                break
            if gi != last_gi:
                chunk = s.chunk_rounds
                last_gi = gi
            elif spent > 0 and call_s > 0:
                rate = spent / call_s
                chunk = max(1, min(4096, int(rate * s.chunk_target_s), chunk * 8))
        if s.polish_rounds > 0:
            viol, cost = measure(goals, dims, static, agg)
            metrics = metrics._replace(violated_after=viol, cost_after=cost)
        host_snap = (snap[0].cpu().numpy(), snap[1].cpu().numpy()) if s.ledger else None
        return agg, _metrics_to_host(metrics), time.monotonic() - t_stack, durs, host_snap

    def _solve_prepared(self, goals, p_orig: int, model: FlatClusterModel, dims: Dims, static,
                        agg, bucketed, raise_on_hard_failure: bool, t0: float) -> OptimizerResult:
        """The back half (optimizer.py:2033): run the goals on a prepared
        (padded) model and diff the placements, cut to the `p_orig` real
        partitions. The scratch lane and the incremental lane both run it:
        their digest contract rests on that."""
        if not goals:
            stats = stats_to_host(compute_stats(model, dims.num_topics))
            return OptimizerResult(
                proposals=[], goal_results=[], stats_before=stats, stats_after=stats,
                final_assignment=model.assignment[:p_orig].cpu().numpy(), num_replica_moves=0,
                num_leadership_moves=0, data_to_move_mb=0.0, duration_s=time.monotonic() - t0,
                bucketed=bucketed,
            )
        init_full = model.assignment.cpu().numpy()
        stats_before = compute_stats(model, dims.num_topics)
        names = tuple(g.name for g in goals)
        ledger_names, ledger_enabled, goal_durs = names, None, None
        if self._settings.chunk_rounds > 0:
            machine_names, enabled, rows = _machine_goal_plan(names)
            agg, metrics_full, stack_s, goal_durs, prov = self._run_chunked(
                goals_by_priority(machine_names), enabled, dims, static, agg)
            ledger_names, ledger_enabled = machine_names, enabled
            metrics = StackMetrics(*(a[rows] for a in metrics_full))
            goal_durs = goal_durs[rows]
        else:
            t_stack = time.monotonic()
            with TRACER.span("optimizer.stack-call", kind="device-call", goal="<fused-stack>",
                             phase="main"), torch.profiler.record_function("cc-stack-call"):
                agg, metrics, prov = run_stack(goals, dims, self._settings, static, agg)
            metrics_full = metrics
            stack_s = time.monotonic() - t_stack
            REGISTRY.meter("GoalOptimizer.device-dispatches").mark()
            REGISTRY.histogram("GoalOptimizer.device-call-timer").record(stack_s)
        stats_after = compute_stats(model._replace(assignment=agg.assignment), dims.num_topics)
        final_np = agg.assignment[:p_orig].cpu().numpy()
        touch_np = agg.touch_tag[:p_orig].cpu().numpy()
        stats_before, stats_after = stats_to_host(stats_before), stats_to_host(stats_after)

        total_rounds = max(1, int(metrics.rounds.sum()))
        if goal_durs is None and int(metrics.rounds.sum()) > 0:
            # fused: a round's time is observable only as the stack's mean
            REGISTRY.histogram("GoalOptimizer.optimizer-round-timer").record(
                stack_s / int(metrics.rounds.sum()))
        goal_results: List[GoalResult] = []
        first_hard_failure: Optional[GoalResult] = None
        for i, goal in enumerate(goals):
            gr = GoalResult(
                name=goal.name,
                is_hard=goal.is_hard,
                violated_brokers_before=int(metrics.violated_before[i]),
                violated_brokers_after=int(metrics.violated_after[i]),
                cost_before=float(metrics.cost_before[i]),
                cost_after=float(metrics.cost_after[i]),
                rounds=int(metrics.rounds[i]),
                converged=bool(metrics.converged[i]),
                # chunked: measured per call; fused: the stack's wall by round share
                duration_s=(float(goal_durs[i]) if goal_durs is not None
                            else stack_s * int(metrics.rounds[i]) / total_rounds),
            )
            goal_results.append(gr)
            # a synthetic span: the goal's interval is attributed, not observed
            TRACER.record_span(
                f"goal:{goal.name}", kind="goal", duration_s=gr.duration_s, goal=goal.name,
                engine=goal_engine(goal, dims, self._settings), rounds=gr.rounds,
                converged=gr.converged, costBefore=gr.cost_before, costAfter=gr.cost_after,
                violatedBefore=gr.violated_brokers_before,
                violatedAfter=gr.violated_brokers_after)
            if gr.is_hard and gr.violated_brokers_after > 0 and first_hard_failure is None:
                first_hard_failure = gr
        if first_hard_failure is not None and raise_on_hard_failure:
            raise OptimizationFailureException(
                f"hard goal {first_hard_failure.name} still violated on "
                f"{first_hard_failure.violated_brokers_after} broker(s)"
            )
        proposals = proposal_diff(init_full[:p_orig], final_np,
                                  model.part_load[:p_orig].cpu().numpy())
        n_moves = sum(len(pr.replicas_to_add) for pr in proposals)
        n_leader = sum(
            1 for pr in proposals if pr.new_leader != pr.old_leader and not pr.replicas_to_add
        )
        provenance = self._build_ledger(ledger_names, ledger_enabled, metrics_full, prov,
                                        init_full, p_orig, dims, bucketed, len(proposals))
        wall = time.monotonic() - t0
        REGISTRY.histogram("GoalOptimizer.proposal-computation-timer").record(wall)
        REGISTRY.histogram("GoalOptimizer.stack-execution-timer").record(stack_s)
        return OptimizerResult(
            proposals=proposals,
            goal_results=goal_results,
            stats_before=stats_before,
            stats_after=stats_after,
            final_assignment=final_np,
            num_replica_moves=n_moves,
            num_leadership_moves=n_leader,
            data_to_move_mb=float(sum(pr.data_to_move_mb for pr in proposals)),
            duration_s=wall,
            touch_tag=touch_np,
            provenance=provenance,
            bucketed=bucketed,
        )

    def _build_ledger(self, ledger_names, enabled, metrics_full: StackMetrics, prov,
                      init_assignment: np.ndarray, p_orig: int, dims: Dims, bucketed,
                      num_proposals: int):
        """Diff the per-phase snapshots into this run's RunLedger and record
        it in provenance.LEDGER (optimizer.py:2208-2275). Phases the enabled
        mask switched off are dropped and the kept ones renumbered, so a
        subset run through the machine and a fused run of the same subset
        build the same ledger."""
        if prov is None or prov[0].shape[0] == 0:
            return None
        g = len(ledger_names)
        n_phases = prov[0].shape[0]
        m = metrics_full
        by_name = {goal.name: goal for goal in goals_by_priority(ledger_names)}
        phases = []
        for i in range(n_phases):
            gi = i % g
            phases.append({
                "goal": ledger_names[gi],
                "engine": goal_engine(by_name[ledger_names[gi]], dims, self._settings),
                "phase": "main" if i < g else "polish",
                "costBefore": float(m.cost_before[gi]),
                "costAfter": float(m.cost_after[gi]),
                "violatedBefore": int(m.violated_before[gi]),
                "violatedAfter": int(m.violated_after[gi]),
                "rounds": int(m.rounds[gi]),
                "converged": bool(m.converged[gi]),
            })
        run_id = new_run_id()
        with TRACER.span("provenance-collect", kind="provenance", runId=run_id) as span:
            ledger = build_run_ledger(
                run_id, phases, init_assignment, prov[0], prov[1],
                valid_partitions=p_orig,
                meta={"bucket": (bucketed or {}).get("bucket"), "numProposals": num_proposals,
                      "goals": list(ledger_names)},
            )
            if enabled is not None:
                keep = [i for i in range(n_phases) if bool(enabled[i % g])]
                index_map = {old: new for new, old in enumerate(keep)}
                ledger.segments = [dataclasses.replace(s, index=index_map[s.index])
                                   for s in ledger.segments if s.index in index_map]
                ledger.moves = [mv._replace(goal_index=index_map[mv.goal_index])
                                for mv in ledger.moves if mv.goal_index in index_map]
            span.attributes["moves"] = len(ledger.moves)
            LEDGER.record(ledger)
        return ledger
