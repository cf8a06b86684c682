"""Batched-greedy goal optimizer, the slice that runs the hard goals.

The counterpart of the JAX package's analyzer/optimizer.py (itself the
replacement of GoalOptimizer.optimizations, cc/analyzer/GoalOptimizer.java:392)
for the settings this port carries so far: the fused goal stack in batched
mode (`batch_k > 1`), every goal on the drain/fill engine, no bulk planner,
no shape bucketing, no polish pass and no provenance ledger. Anything else
raises NotImplementedError naming the ROADMAP.md item that brings it.

The JAX package runs each goal's rounds as a device `while_loop`; here the
round loop is a host loop over device work that reads one device value per
round, the loop condition (`empties`, optimizer.py:673-675 in the JAX code).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cruise_control_torch.analyzer.acceptance import empty_tables
from cruise_control_torch.analyzer.context import (
    Dims,
    OptimizationOptions,
    build_static_ctx,
    compute_aggregates,
    dims_of,
    replicas_on_dead,
)
from cruise_control_torch.analyzer.drain import make_drain_round
from cruise_control_torch.analyzer.goals import goals_by_priority
from cruise_control_torch.analyzer.goals.base import SCORE_EPS, UnportedGoal
from cruise_control_torch.analyzer.proposals import ExecutionProposal, proposal_diff
from cruise_control_torch.config.balancing import BalancingConstraint
from cruise_control_torch.models.flat_model import FlatClusterModel


class OptimizationFailureException(Exception):
    """A hard goal could not be satisfied (reference:
    com.linkedin.kafka.cruisecontrol.exception.OptimizationFailureException)."""


@dataclasses.dataclass(frozen=True)
class OptimizerSettings:
    """Tuning knobs, with the JAX package's names and defaults (the fields the
    slice reads or refuses; the grid, swap, cost-scaled-cap and bucket-ladder
    knobs come with the code that reads them). The port runs
    `SLICE_SETTINGS`; check_supported lists what it refuses."""

    batch_k: int = 64
    max_rounds_per_goal: int = 64
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


#: The settings of the ported slice: the service defaults
#: (cruise_config.py:102-130) on the fused stack, without shape bucketing,
#: the bulk planner or the provenance ledger.
SLICE_SETTINGS = OptimizerSettings(
    batch_k=16, max_rounds_per_goal=64, drain_src=512,
    drain_per_broker=8, drain_dst=64, apply_waves=8, bulk_waves=0, polish_rounds=0,
    chunk_rounds=0, bucket_partitions=False, bucket_brokers=False, ledger=False,
)


def goal_engine(goal, dims: Dims, settings: OptimizerSettings) -> str:
    """Which search engine a goal runs under these settings/dims (the JAX
    package's labels). The reference also sends swap and pair-drain goals to
    the drain engine at `batch_k == 1`; the port has no such goal yet."""
    use_bulk = (
        settings.bulk_waves > 0
        and dims.num_brokers >= settings.bulk_min_brokers
        and goal.count_family
    )
    engine = "drain" if settings.batch_k > 1 else "grid"
    if use_bulk:
        engine = f"bulk+{engine}"
    if settings.polish_rounds > 0:
        engine += "+polish"
    return engine


def check_supported(goals, dims: Dims, settings: OptimizerSettings,
                    options: OptimizationOptions) -> None:
    """Raise NotImplementedError for anything outside the ported slice."""

    def refuse(what: str, item: str):
        raise NotImplementedError(f"{what} is not ported yet ({item})")

    q2 = "ROADMAP.md Queue 1 item 3, slice 2"
    q4 = "ROADMAP.md Queue 1 item 4, production solve plumbing"
    for g in goals:
        if isinstance(g, UnportedGoal):
            refuse(f"goal {g.name}", q2)
        # the grid (batch_k=1), the bulk planner and the polish pass
        engine = goal_engine(g, dims, settings)
        if engine != "drain":
            refuse(f"the {engine} engine for {g.name}", q2)
    if settings.chunk_rounds > 0:
        refuse("the chunked goal machine (chunk_rounds > 0)", q4)
    if settings.bucket_partitions or settings.bucket_brokers:
        refuse("shape bucketing (bucket_partitions / bucket_brokers)", q4)
    if settings.ledger:
        refuse("the provenance ledger (ledger=True)", q4)
    # every option defaults to None or False; the port takes the defaults only
    for field in dataclasses.fields(options):
        value = getattr(options, field.name)
        if value is not None and value is not False:
            refuse(f"the option {field.name}", q4)


def _make_goal_loop(goal, dims: Dims, settings: OptimizerSettings):
    """goal_loop(static, agg, tables) -> (agg, rounds, empties): drain rounds
    until the goal stalls or its round cap; `agg` is updated in place."""
    drain_fn = make_drain_round(goal, dims, settings.drain_src, settings.drain_per_broker,
                                settings.drain_dst, settings.apply_waves)
    empties_to_stall = 1

    def goal_loop(static, agg, tables):
        gs0 = goal.prepare(static, agg, dims)
        budget = settings.max_rounds_per_goal
        dev = agg.assignment.device
        empties = torch.zeros((), dtype=torch.int32, device=dev)
        stall = torch.tensor(empties_to_stall, dtype=torch.int32, device=dev)
        rnd = 0
        # the loop condition is the one device value read per round
        while rnd < budget and int(empties) < empties_to_stall:
            contrib = goal.drain_contrib(static, gs0, agg)
            agg, applied = drain_fn(static, agg, tables, gs0, contrib, rnd)
            # a zero-cost goal with no dead-broker replicas left is done
            satisfied = (goal.cost(static, gs0, agg) <= SCORE_EPS) & ~torch.any(
                replicas_on_dead(static, agg.assignment))
            empties = torch.where(satisfied, stall,
                                  torch.where(applied, torch.zeros_like(empties), empties + 1))
            rnd += 1
        return agg, rnd, int(empties)

    goal_loop.empties_to_stall = empties_to_stall
    return goal_loop


class StackMetrics(NamedTuple):
    """Per-goal diagnostics of one stack run; row i = i-th goal."""

    violated_before: np.ndarray  # i32[G]
    violated_after: np.ndarray  # i32[G]
    cost_before: np.ndarray  # f32[G]
    cost_after: np.ndarray  # f32[G]
    rounds: np.ndarray  # i32[G]
    #: True when the goal stalled rather than exhausting its round cap
    converged: np.ndarray  # bool[G]


def run_stack(goals, dims: Dims, settings: OptimizerSettings, static, agg):
    """Run the priority-ordered goal stack (the JAX package's
    _make_stack_step, :823-889): each goal's loop feeds the next, and each
    finished goal contributes its bounds to the merged acceptance tables.
    Returns (agg, StackMetrics)."""
    tables = empty_tables(dims, agg.assignment.device)
    vb, va, cb, ca, rs, cv = [], [], [], [], [], []
    for goal in goals:
        loop = _make_goal_loop(goal, dims, settings)
        gs0 = goal.prepare(static, agg, dims)
        vb.append(torch.sum(goal.broker_violation(static, gs0, agg)).to(torch.int32))
        cb.append(goal.cost(static, gs0, agg).to(torch.float32))
        agg, rounds, empties = loop(static, agg, tables)
        gs1 = goal.prepare(static, agg, dims)
        va.append(torch.sum(goal.broker_violation(static, gs1, agg)).to(torch.int32))
        ca.append(goal.cost(static, gs1, agg).to(torch.float32))
        rs.append(rounds)
        cv.append(empties >= loop.empties_to_stall)
        tables = goal.contribute_acceptance(static, gs1, tables)
    metrics = StackMetrics(
        violated_before=torch.stack(vb).cpu().numpy(),
        violated_after=torch.stack(va).cpu().numpy(),
        cost_before=torch.stack(cb).cpu().numpy(),
        cost_after=torch.stack(ca).cpu().numpy(),
        rounds=np.asarray(rs, dtype=np.int32),
        converged=np.asarray(cv, dtype=bool),
    )
    return agg, metrics


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
    """The analog of GoalOptimizer.OptimizerResult (GoalOptimizer.java:537).
    `stats_before` / `stats_after` stay None until analyzer/stats.py is
    ported (ROADMAP.md Queue 1 item 4)."""

    proposals: List[ExecutionProposal]
    goal_results: List[GoalResult]
    stats_before: Optional[object]
    stats_after: Optional[object]
    final_assignment: np.ndarray
    num_replica_moves: int
    num_leadership_moves: int
    data_to_move_mb: float
    duration_s: float
    #: the final touch tags i32[P, R] (packed round/wave of each cell's last write)
    touch_tag: Optional[np.ndarray] = None

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
        check_supported(goals, dims, self._settings, options)
        static = build_static_ctx(model, self._constraint, dims)
        init_np = model.assignment.cpu().numpy()
        part_load_np = model.part_load.cpu().numpy()
        if not goals:
            return OptimizerResult(
                proposals=[], goal_results=[], stats_before=None, stats_after=None,
                final_assignment=init_np, num_replica_moves=0, num_leadership_moves=0,
                data_to_move_mb=0.0, duration_s=time.monotonic() - t0,
            )
        return self._solve_prepared(goals, dims, static, model, init_np, part_load_np,
                                    raise_on_hard_failure, t0)

    def _solve_prepared(self, goals, dims, static, model, init_np, part_load_np,
                        raise_on_hard_failure: bool, t0: float) -> OptimizerResult:
        agg = compute_aggregates(static, model.assignment, dims)
        t_stack = time.monotonic()
        agg, metrics = run_stack(goals, dims, self._settings, static, agg)
        final_np = agg.assignment.cpu().numpy()
        touch_np = agg.touch_tag.cpu().numpy()
        stack_s = time.monotonic() - t_stack

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
                # attributed by round share of the stack's wall time
                duration_s=stack_s * int(metrics.rounds[i]) / total_rounds,
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
        return OptimizerResult(
            proposals=proposals,
            goal_results=goal_results,
            stats_before=None,
            stats_after=None,
            final_assignment=final_np,
            num_replica_moves=n_moves,
            num_leadership_moves=n_leader,
            data_to_move_mb=float(sum(pr.data_to_move_mb for pr in proposals)),
            duration_s=time.monotonic() - t0,
            touch_tag=touch_np,
        )
