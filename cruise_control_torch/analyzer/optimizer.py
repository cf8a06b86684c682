"""Batched-greedy goal optimizer: the goal stack on the card.

The counterpart of the JAX package's analyzer/optimizer.py (itself the
replacement of GoalOptimizer.optimizations, cc/analyzer/GoalOptimizer.java:392)
for the settings this port carries: batched mode (`batch_k > 1`) with every
engine of the default stack (the drain/fill rounds, the bulk count planner,
the replica swaps, the topic goal's pair drain and topic swaps, the
leadership relays), run either as the fused stack (`chunk_rounds = 0`) or
through the chunked goal machine (`chunk_rounds > 0`, the service default,
`SERVICE_SETTINGS`), with the provenance ledger and the before/after cluster
statistics. The polish pass, the `batch_k=1` grid and shape bucketing raise
NotImplementedError naming the ROADMAP.md item that brings them.

The JAX package runs each goal's rounds as a device `while_loop`; here the
round loop is a host loop over device work that reads one device value per
round, the loop condition (`empties`, optimizer.py:673-675 in the JAX code),
plus the bulk planner's and the fallbacks' `applied` flags. The goal
machine's cursor (goal, rounds in it, empty-round streak) is therefore
already on the host, and a machine call reads back only the per-goal round
counts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cruise_control_torch.analyzer.acceptance import empty_tables
from cruise_control_torch.analyzer.bulk import make_bulk_count_round
from cruise_control_torch.analyzer.context import (
    Dims,
    OptimizationOptions,
    build_static_ctx,
    compute_aggregates,
    dims_of,
    replicas_on_dead,
)
from cruise_control_torch.analyzer.drain import (
    make_drain_round,
    make_leadership_relay_round,
    make_pair_drain_round,
    make_topic_swap_round,
    round_jitter,
)
from cruise_control_torch.analyzer.goals import DEFAULT_GOAL_ORDER, goals_by_priority
from cruise_control_torch.analyzer.goals.base import SCORE_EPS, UnportedGoal
from cruise_control_torch.analyzer.proposals import ExecutionProposal, proposal_diff
from cruise_control_torch.analyzer.provenance import LEDGER, build_run_ledger, new_run_id
from cruise_control_torch.analyzer.stats import ClusterModelStats, compute_stats, stats_to_host
from cruise_control_torch.analyzer.swaps import make_swap_round
from cruise_control_torch.config.balancing import BalancingConstraint
from cruise_control_torch.kernels.state_fingerprint import state_fingerprint
from cruise_control_torch.models.flat_model import FlatClusterModel


class OptimizationFailureException(Exception):
    """A hard goal could not be satisfied (reference:
    com.linkedin.kafka.cruisecontrol.exception.OptimizationFailureException)."""


@dataclasses.dataclass(frozen=True)
class OptimizerSettings:
    """Tuning knobs, with the JAX package's names and defaults (the fields the
    port reads or refuses; the grid's and the cost-scaled cap's knobs come
    with the code that reads them). check_supported lists what it refuses."""

    batch_k: int = 64
    max_rounds_per_goal: int = 64
    num_swap_pairs: int = 8
    swap_candidates: int = 8
    swaps_per_broker: int = 4
    bucket_partitions: bool = True
    bucket_brokers: bool = True
    chunk_rounds: int = 0
    apply_waves: int = 8
    drain_src: int = 512
    drain_per_broker: int = 8
    drain_dst: int = 64
    bulk_waves: int = 16
    bulk_min_brokers: int = 32
    polish_rounds: int = 0
    ledger: bool = True


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

#: What the service runs: STACK_SETTINGS through the chunked goal machine
#: (`optimizer.chunk.rounds` = 32, cruise_config.py:112) with the provenance
#: ledger (`optimizer.provenance.ledger`, cruise_config.py:426): the service
#: defaults but shape bucketing.
SERVICE_SETTINGS = dataclasses.replace(STACK_SETTINGS, chunk_rounds=32, ledger=True)


#: chunked mode: the target wall time of a machine call, from which later
#: calls' budgets follow the measured round rate (the JAX package's
#: `chunk_target_s` default)
CHUNK_TARGET_S = 10.0


def _use_bulk(goal, dims: Dims, settings: OptimizerSettings) -> bool:
    return (settings.bulk_waves > 0 and dims.num_brokers >= settings.bulk_min_brokers
            and goal.count_family)


def goal_engine(goal, dims: Dims, settings: OptimizerSettings) -> str:
    """Which search engine a goal runs under these settings/dims (the JAX
    package's labels, optimizer.py:254)."""
    use_bulk = _use_bulk(goal, dims, settings)
    use_drain = settings.batch_k > 1 or goal.uses_swaps or (use_bulk and goal.pair_drain)
    engine = "drain" if use_drain else "grid"
    if use_bulk:
        engine = f"bulk+{engine}"
    if settings.polish_rounds > 0:
        engine += "+polish"
    return engine


def check_supported(goals, settings: OptimizerSettings, options: OptimizationOptions) -> None:
    """Raise NotImplementedError for anything outside the ported slices."""

    def refuse(what: str, item: str):
        raise NotImplementedError(f"{what} is not ported yet ({item})")

    q3b = "ROADMAP.md Queue 1 item 3: left out of slice 2, it comes with slice 3b"
    q4 = "ROADMAP.md Queue 1 item 4, production solve plumbing"
    for g in goals:
        if isinstance(g, UnportedGoal):
            refuse(f"goal {g.name}", q4)
    if settings.batch_k <= 1:
        refuse("the batch_k=1 grid engine", q3b)
    if settings.polish_rounds > 0:
        refuse("the polish pass (polish_rounds > 0)", q3b)
    if settings.bucket_partitions or settings.bucket_brokers:
        refuse("shape bucketing (bucket_partitions / bucket_brokers)", q4)
    # every option defaults to None or False; the port takes the defaults only
    for field in dataclasses.fields(options):
        value = getattr(options, field.name)
        if value is not None and value is not False:
            refuse(f"the option {field.name}", q4)


def _swap_width(num_brokers: int, num_swap_pairs: int) -> int:
    """The swap round's hot/cold width (optimizer.py:612-614): a sixteenth
    of the brokers, up to the next power of two, within [num_swap_pairs,
    128]; 128 at 2,600 brokers."""
    width = num_brokers // 16
    width = 1 << max(0, width - 1).bit_length() if width > 1 else width
    return max(num_swap_pairs, min(128, width))


def _make_goal_loop(goal, dims: Dims, settings: OptimizerSettings):
    """goal_loop(static, agg, tables, budget, rnd_base, empties0, stall_at)
    -> (agg, rounds, empties): rounds until the goal stalls or `budget` more
    rounds ran (optimizer.py:536-775); `agg` is updated in place. Each round:
    the bulk planner first (count goals), then, when it applied nothing, the
    goal's engine, then its stall fallbacks (swaps, topic swaps, relays) only
    while nothing has applied. `rnd_base` and `empties0` resume a goal paused
    by the chunked machine: the absolute round index seeds the round jitter
    and the touch tags, and the empty-round streak carries over."""
    use_bulk = _use_bulk(goal, dims, settings)
    bulk_fn = None
    if use_bulk and not goal.pair_drain:
        bulk_fn = make_bulk_count_round(goal, dims, settings.drain_per_broker, settings.bulk_waves)
    topic_swap_fn = lead_swap_fn = swap_fn = None
    if goal.pair_drain:
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


def run_stack(goals, dims: Dims, settings: OptimizerSettings, static, agg):
    """Run the priority-ordered goal stack (the JAX package's
    _make_stack_step, :823-889): each goal's loop feeds the next, and each
    finished goal contributes its bounds to the merged acceptance tables.
    With the ledger on, the assignment and touch tags are snapshotted after
    each goal. Returns (agg, StackMetrics, snapshots or None), on the host."""
    tables = empty_tables(dims, agg.assignment.device)
    vb, va, cb, ca, rs, cv, fps, snaps_a, snaps_t = [], [], [], [], [], [], [], [], []
    for goal in goals:
        loop = _make_goal_loop(goal, dims, settings)
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
        if settings.ledger:
            snaps_a.append(agg.assignment.clone())
            snaps_t.append(agg.touch_tag.clone())
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

        machine(static, agg, tables, goal_idx, rounds_in_goal, empties_in_goal,
                metrics, budget, enabled, snap)
          -> (agg, tables, goal_idx, rounds_in_goal, empties_in_goal, metrics,
              spent, snap)

    advances the stack by up to `budget` rounds, crossing goal boundaries. A
    goal's entry row (violated_before, cost_before) is written the first
    time it runs; its exit row, state fingerprint included, at every pause
    or exit; its tables only when it is done (stalled, or its round cap
    reached), and then its snapshot row. A disabled goal (`enabled[i]`
    False) advances the cursor with no rounds, no tables and untouched
    metrics rows, and writes its snapshot row from the unchanged state
    (skip_branch, :1107-1121). `metrics` and `snap` are updated in place; the
    cursor is host ints. The polish phases are not ported (slice 3b)."""
    loops = [_make_goal_loop(g, dims, settings) for g in goals]
    n_goals = len(goals)
    cap = settings.max_rounds_per_goal

    def machine(static, agg, tables, goal_idx: int, rounds_in_goal: int, empties_in_goal: int,
                metrics: StackMetrics, budget: int, enabled, snap):
        gi, rig, emp, left = goal_idx, rounds_in_goal, empties_in_goal, budget
        snap_a, snap_t = snap

        def snapshot(row):
            if snap_a.shape[0]:
                snap_a[row].copy_(agg.assignment)
                snap_t[row].copy_(agg.touch_tag)

        while left > 0 and gi < n_goals:
            goal, loop = goals[gi], loops[gi]
            if not enabled[gi]:
                snapshot(gi)
                gi, rig, emp = gi + 1, 0, 0
                continue
            if rig == 0:
                # the JAX machine measures the entry state on every entry and
                # records it on the first only (:986-1000)
                gs_in = goal.prepare(static, agg, dims)
                metrics.violated_before[gi] = _violated(goal, static, gs_in, agg)
                metrics.cost_before[gi] = goal.cost(static, gs_in, agg)
            agg, rounds, emp2 = loop(static, agg, tables, min(left, cap - rig), rnd_base=rig,
                                     empties0=emp)
            rig2 = rig + rounds
            stalled = emp2 >= loop.empties_to_stall
            done = stalled or rig2 >= cap
            gs_out = goal.prepare(static, agg, dims)
            metrics.violated_after[gi] = _violated(goal, static, gs_out, agg)
            metrics.cost_after[gi] = goal.cost(static, gs_out, agg)
            metrics.rounds[gi] = rig2
            metrics.converged[gi] = stalled
            metrics.state_fp[gi] = state_fingerprint(agg)
            left -= rounds
            if done:
                tables = goal.contribute_acceptance(static, gs_out, tables)
                snapshot(gi)
                gi, rig, emp = gi + 1, 0, 0
            else:
                rig, emp = rig2, emp2
        return agg, tables, gi, rig, emp, metrics, budget - left, snap

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

    @property
    def violated_goals_before(self) -> List[str]:
        return [g.name for g in self.goal_results if g.violated_brokers_before]

    @property
    def violated_goals_after(self) -> List[str]:
        return [g.name for g in self.goal_results if g.violated_brokers_after]


class GoalOptimizer:
    """Runs goals in priority order against one flattened cluster model, on
    `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, constraint: Optional[BalancingConstraint] = None,
                 settings: OptimizerSettings = SLICE_SETTINGS, device="cuda"):
        self._constraint = constraint or BalancingConstraint.default()
        self._settings = settings
        self._device = torch.device(device)

    def optimizations(
        self,
        model: FlatClusterModel,
        goal_names: Optional[Sequence[str]] = None,
        options: OptimizationOptions = OptimizationOptions(),
        raise_on_hard_failure: bool = True,
    ) -> OptimizerResult:
        """Run the requested goal stack and diff initial vs final placement."""
        t0 = time.monotonic()
        goals = goals_by_priority(goal_names)
        model = model.to(self._device)
        dims = dims_of(model)
        check_supported(goals, self._settings, options)
        static = build_static_ctx(model, self._constraint, dims)
        init_np = model.assignment.cpu().numpy()
        part_load_np = model.part_load.cpu().numpy()
        if not goals:
            stats = stats_to_host(compute_stats(model, dims.num_topics))
            return OptimizerResult(
                proposals=[], goal_results=[], stats_before=stats, stats_after=stats,
                final_assignment=init_np, num_replica_moves=0, num_leadership_moves=0,
                data_to_move_mb=0.0, duration_s=time.monotonic() - t0,
            )
        return self._solve_prepared(goals, dims, static, model, init_np, part_load_np,
                                    raise_on_hard_failure, t0)

    def _run_chunked(self, goals, enabled: np.ndarray, dims: Dims, static, agg):
        """Drive the goal machine (optimizer.py:1553-1653): calls of at most
        `chunk` rounds each, crossing goal boundaries. After each call the
        per-goal round counts are read back once, the call's wall time is
        attributed to goals by their share of its rounds, and the next
        budget follows the measured round rate (at most 8x the last, back to
        `chunk_rounds` at a goal boundary). Decisions do not depend on where
        the calls end. Returns (agg, host metrics, stack seconds, per-goal
        seconds, host snapshots or None); rows follow `goals`."""
        s = self._settings
        dev = agg.assignment.device
        n = len(goals)
        tables = empty_tables(dims, dev)
        metrics = empty_stack_metrics(n, dev)
        snap = empty_prov_snapshots(n, dims, s.ledger, dev)
        machine = _make_goal_machine(goals, dims, s)
        gi = rig = emp = 0
        chunk = s.chunk_rounds
        durs = np.zeros(n, np.float64)
        rounds_seen = np.zeros(n, np.int64)
        last_gi = 0
        t_stack = time.monotonic()
        while True:
            t_call = time.monotonic()
            agg, tables, gi, rig, emp, metrics, spent, snap = machine(
                static, agg, tables, gi, rig, emp, metrics, max(1, chunk), enabled, snap)
            rounds_h = metrics.rounds.cpu().numpy().astype(np.int64)
            call_s = time.monotonic() - t_call
            delta = np.maximum(rounds_h - rounds_seen, 0)
            if delta.sum() > 0:
                durs += call_s * delta / delta.sum()
            rounds_seen = np.maximum(rounds_seen, rounds_h)
            if gi >= n:
                break
            if gi != last_gi:
                chunk = s.chunk_rounds
                last_gi = gi
            elif spent > 0 and call_s > 0:
                rate = spent / call_s
                chunk = max(1, min(4096, int(rate * CHUNK_TARGET_S), chunk * 8))
        host_snap = (snap[0].cpu().numpy(), snap[1].cpu().numpy()) if s.ledger else None
        return agg, _metrics_to_host(metrics), time.monotonic() - t_stack, durs, host_snap

    def _solve_prepared(self, goals, dims, static, model, init_np, part_load_np,
                        raise_on_hard_failure: bool, t0: float) -> OptimizerResult:
        stats_before = compute_stats(model, dims.num_topics)
        agg = compute_aggregates(static, model.assignment, dims)
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
            agg, metrics, prov = run_stack(goals, dims, self._settings, static, agg)
            metrics_full = metrics
            stack_s = time.monotonic() - t_stack
        stats_after = compute_stats(model._replace(assignment=agg.assignment), dims.num_topics)
        final_np = agg.assignment.cpu().numpy()
        touch_np = agg.touch_tag.cpu().numpy()
        stats_before, stats_after = stats_to_host(stats_before), stats_to_host(stats_after)

        total_rounds = max(1, int(metrics.rounds.sum()))
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
            if gr.is_hard and gr.violated_brokers_after > 0 and first_hard_failure is None:
                first_hard_failure = gr
        if first_hard_failure is not None and raise_on_hard_failure:
            raise OptimizationFailureException(
                f"hard goal {first_hard_failure.name} still violated on "
                f"{first_hard_failure.violated_brokers_after} broker(s)"
            )
        proposals = proposal_diff(init_np, final_np, part_load_np)
        n_moves = sum(len(pr.replicas_to_add) for pr in proposals)
        n_leader = sum(
            1 for pr in proposals if pr.new_leader != pr.old_leader and not pr.replicas_to_add
        )
        provenance = self._build_ledger(ledger_names, ledger_enabled, metrics_full, prov,
                                        init_np, dims, len(proposals))
        return OptimizerResult(
            proposals=proposals,
            goal_results=goal_results,
            stats_before=stats_before,
            stats_after=stats_after,
            final_assignment=final_np,
            num_replica_moves=n_moves,
            num_leadership_moves=n_leader,
            data_to_move_mb=float(sum(pr.data_to_move_mb for pr in proposals)),
            duration_s=time.monotonic() - t0,
            touch_tag=touch_np,
            provenance=provenance,
        )

    def _build_ledger(self, ledger_names, enabled, metrics_full: StackMetrics, prov,
                      init_assignment: np.ndarray, dims: Dims, num_proposals: int):
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
        ledger = build_run_ledger(
            new_run_id(), phases, init_assignment, prov[0], prov[1],
            valid_partitions=dims.num_partitions,
            meta={"bucket": None, "numProposals": num_proposals, "goals": list(ledger_names)},
        )
        if enabled is not None:
            keep = [i for i in range(n_phases) if bool(enabled[i % g])]
            index_map = {old: new for new, old in enumerate(keep)}
            ledger.segments = [dataclasses.replace(s, index=index_map[s.index])
                               for s in ledger.segments if s.index in index_map]
            ledger.moves = [mv._replace(goal_index=index_map[mv.goal_index])
                            for mv in ledger.moves if mv.goal_index in index_map]
        LEDGER.record(ledger)
        return ledger
