"""Kernel entry-point registry for the port's cclint trace tier.

The certification manifest of the port's kernel stack: the ten surfaces of
the JAX package's registry, under the same names, each built here over a
small concrete problem on the worker's device, and run by the trace worker
(lint/trace_worker.py) under a PyTorch dispatch recorder — on the card,
through the hand kernels. Findings and their suppressions anchor to the
`name="..."` line of the entry below, so this file is also where every
trace-tier waiver lives, in plain sight.

Registered surfaces (the production call sites in analyzer/optimizer.py
`run_stack` / `_make_goal_machine` / `_make_goal_loop`, the round
factories, parallel/ and the lane):

  fused-stack-step          the whole priority stack (run_stack), polish on;
                            writes the Aggregates in place
  chunked-goal-machine      the bounded-duration stack executor; writes the
                            Aggregates, the metrics rows and the ledger's
                            snapshot rows in place
  bulk-count-round          the count-family surplus/deficit wave planner
  pair-drain-round          the (topic, broker) pair drain engine
  swap-round                the resource-distribution swap engine
  sharded-compute-aggregates  K1 over the mesh-placed static context
  sharded-compute-stats     K8's model stats over the mesh-placed model
  spmd-grid-shortlist       K9 a shard, one gather, K12's merge
                            (parallel/spmd.py, batch_k=1 grid engine)
  spmd-partition-stats      K13 a shard and one integer sum
  incremental-delta-apply   the lane's model-delta scatter (K10)

Where the JAX registry declares `donate_argnums`, this one declares
`mutates_argnums`: what the port's call site writes in place (the JAX
stack donates the Aggregates, (1,); the machine (1, 2, 6, 9), of which the
port writes the Aggregates, the metrics and the snapshots in place and
returns fresh tables). Round entries declare `carry`: they run twice with
their state fed back.

Everything heavy is imported inside the build functions: this module is
imported by the trace worker only — the in-process linter merely scans it
for the `CCLINT_TRACE_ENTRYPOINTS` declaration. The model is the tiny `unbalanced()`
generator padded to 8 partitions, so the mesh entries can cut it in 8.
"""

from __future__ import annotations

#: Per-entry collective budgets a call (DeviceTelemetry.collective_totals();
#: the JAX numbers count XLA HLO lines and do not carry over). The mesh is
#: single-controller (ROADMAP "The mesh is single-controller"):
#:
#: * the SPMD grid shortlist — its design IS one gather of the shards'
#:   shortlist records into one tensor on the first device, then K12's merge
#:   there; a second gather would move more than records.
SPMD_SHORTLIST_COLLECTIVES = {"all-gather": 1}
#: * the partition-stats certificate — no gather: each shard's K13 counts
#:   are summed as integers, one all-reduce.
SPMD_STATS_COLLECTIVES = {"all-reduce": 1}
#: * the sharded aggregates and stats — no collective at all: they run whole
#:   on the mesh's first device.
WHOLE_ON_FIRST_DEVICE_COLLECTIVES: dict = {}

#: shards of the mesh entries, all on the worker's one device
MESH_SIZE = 8
#: the machine's round budget a call: the tiny stack takes a few rounds a
#: goal, so two calls cross every goal and reach the polish phases
MACHINE_BUDGET = 64
#: polish rounds for the stack and the machine, so their polish phases (and
#: the machine's reads of a goal's converged flag there) run
POLISH_ROUNDS = 4


def _tiny_problem(device):
    """One small concrete problem instance on `device`, shared by the
    build functions: (padded model, dims, static context, aggregates)."""
    from cruise_control_torch.analyzer.context import (
        build_static_ctx,
        compute_aggregates,
        dims_of,
    )
    from cruise_control_torch.config.balancing import BalancingConstraint
    from cruise_control_torch.models.generators import unbalanced
    from cruise_control_torch.parallel.sharding import pad_partitions

    # pad the partition axis to the mesh size so the SAME instance serves
    # the mesh entries (8 | P is the placement's precondition)
    model = pad_partitions(unbalanced(), MESH_SIZE).to(device)
    dims = dims_of(model)
    static = build_static_ctx(model, BalancingConstraint.default(), dims)
    agg = compute_aggregates(static, model.assignment, dims)
    return model, dims, static, agg


def _stack_settings():
    """The service's settings (chunked machine, bulk planner, ledger) with
    the polish pass on."""
    import dataclasses

    from cruise_control_torch.analyzer.optimizer import SERVICE_SETTINGS

    return dataclasses.replace(SERVICE_SETTINGS, polish_rounds=POLISH_ROUNDS)


def _mesh(device):
    from cruise_control_torch.parallel.sharding import make_mesh

    return make_mesh(MESH_SIZE, devices=[device] * MESH_SIZE)


def _build_fused_stack(device):
    import functools

    from cruise_control_torch.analyzer.goals import goals_by_priority
    from cruise_control_torch.analyzer.optimizer import run_stack

    _model, dims, static, agg = _tiny_problem(device)
    fn = functools.partial(run_stack, goals_by_priority(), dims, _stack_settings())
    return dict(fn=fn, args=(static, agg), mutates_argnums=(1,), carry=((0, 1),))


def _build_goal_machine(device):
    import numpy as np

    from cruise_control_torch.analyzer.acceptance import empty_tables
    from cruise_control_torch.analyzer.goals import goals_by_priority
    from cruise_control_torch.analyzer.optimizer import (
        _make_goal_machine,
        empty_prov_snapshots,
        empty_stack_metrics,
    )

    _model, dims, static, agg = _tiny_problem(device)
    goals = goals_by_priority()
    settings = _stack_settings()
    fn = _make_goal_machine(goals, dims, settings)
    args = (
        static, agg, empty_tables(dims, device), 0, 0, 0,
        empty_stack_metrics(len(goals), device), MACHINE_BUDGET,
        np.ones(len(goals), dtype=bool),
        empty_prov_snapshots(fn.n_phases, dims, settings.ledger, device),
    )
    # machine(...) -> (agg, tables, phase, rounds_in_goal, empties_in_goal,
    # metrics, spent, snap): the cursor and the state feed the next call
    carry = ((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (7, 9))
    return dict(fn=fn, args=args, mutates_argnums=(1, 6, 9), carry=carry)


def _round_args(device, goal_name):
    from cruise_control_torch.analyzer.acceptance import empty_tables
    from cruise_control_torch.analyzer.goals import GOAL_REGISTRY

    _model, dims, static, agg = _tiny_problem(device)
    goal = GOAL_REGISTRY[goal_name]
    gs = goal.prepare(static, agg, dims)
    contrib = goal.drain_contrib(static, gs, agg)
    return goal, dims, static, agg, empty_tables(dims, device), gs, contrib


def _build_bulk_round(device):
    from cruise_control_torch.analyzer.bulk import make_bulk_count_round

    goal, dims, static, agg, tables, gs, contrib = _round_args(device, "ReplicaDistributionGoal")
    settings = _stack_settings()
    fn = make_bulk_count_round(goal, dims, settings.drain_per_broker, settings.bulk_waves)
    return dict(fn=fn, args=(static, agg, tables, gs, contrib, 0), mutates_argnums=(1,),
                carry=((0, 1),))


def _build_pair_drain_round(device):
    from cruise_control_torch.analyzer.drain import make_pair_drain_round

    goal, dims, static, agg, tables, gs, contrib = _round_args(
        device, "TopicReplicaDistributionGoal")
    settings = _stack_settings()
    fn = make_pair_drain_round(goal, dims, settings.drain_src, settings.apply_waves)
    return dict(fn=fn, args=(static, agg, tables, gs, contrib, 0), mutates_argnums=(1,),
                carry=((0, 1),))


def _build_swap_round(device):
    from cruise_control_torch.analyzer.optimizer import _swap_width
    from cruise_control_torch.analyzer.swaps import make_swap_round

    goal, dims, static, agg, tables, _gs, contrib = _round_args(
        device, "DiskUsageDistributionGoal")
    s = _stack_settings()
    fn = make_swap_round(goal, dims, _swap_width(dims.num_brokers, s.num_swap_pairs),
                         s.swap_candidates, s.swaps_per_broker, s.apply_waves)
    return dict(fn=fn, args=(static, agg, tables, contrib, 0), mutates_argnums=(1,),
                carry=((0, 1),))


def _build_sharded_aggregates(device):
    import functools

    from cruise_control_torch.analyzer.context import compute_aggregates
    from cruise_control_torch.parallel.sharding import place_static

    model, dims, static, _agg = _tiny_problem(device)
    fn = functools.partial(compute_aggregates, dims=dims)
    return dict(fn=fn, args=(place_static(static, _mesh(device)), model.assignment),
                collectives=WHOLE_ON_FIRST_DEVICE_COLLECTIVES)


def _build_sharded_stats(device):
    import functools

    from cruise_control_torch.analyzer.stats import compute_stats
    from cruise_control_torch.parallel.sharding import shard_model

    model, dims, _static, _agg = _tiny_problem(device)
    fn = functools.partial(compute_stats, num_topics=dims.num_topics)
    return dict(fn=fn, args=(shard_model(model, _mesh(device)),),
                collectives=WHOLE_ON_FIRST_DEVICE_COLLECTIVES)


def _build_spmd_grid_shortlist(device):
    import dataclasses

    import torch

    from cruise_control_torch.analyzer.acceptance import empty_tables
    from cruise_control_torch.analyzer.goals import GOAL_REGISTRY
    from cruise_control_torch.parallel import spmd
    from cruise_control_torch.parallel.sharding import place_static

    _model, dims, static, agg = _tiny_problem(device)
    # batch_k=1 is the greedy grid engine's mode — the regime the mesh
    # shortlist serves (optimizer._make_grid_round)
    settings = dataclasses.replace(_stack_settings(), batch_k=1)
    goal = GOAL_REGISTRY["DiskUsageDistributionGoal"]
    gs = goal.prepare(static, agg, dims)
    dst_cands = torch.arange(min(dims.num_brokers, 16), dtype=torch.int32, device=device)
    mesh = _mesh(device)
    fn = spmd.make_grid_shortlist(mesh, goal, dims, settings)
    return dict(fn=fn, args=(place_static(static, mesh), agg, gs, empty_tables(dims, device),
                             dst_cands),
                collectives=SPMD_SHORTLIST_COLLECTIVES)


def _build_spmd_partition_stats(device):
    from cruise_control_torch.parallel import spmd
    from cruise_control_torch.parallel.sharding import place_static

    _model, _dims, static, agg = _tiny_problem(device)
    mesh = _mesh(device)
    return dict(fn=spmd.make_partition_stats(mesh), args=(place_static(static, mesh), agg),
                collectives=SPMD_STATS_COLLECTIVES)


def _build_incremental_delta_apply(device):
    import numpy as np

    from cruise_control_torch.analyzer import incremental as inc
    from cruise_control_torch.common.resources import BrokerState
    from cruise_control_torch.kernels.delta_scatter import delta_scatter

    _model, _dims, static, _agg = _tiny_problem(device)
    num_metrics = int(static.part_load.shape[1])
    deltas = [
        inc.ModelDelta(kind=inc.DELTA_BROKER_DEATH, broker=0, state=int(BrokerState.DEAD)),
        inc.ModelDelta(kind=inc.DELTA_LOAD_SPIKE, row=1, load=np.ones(num_metrics, np.float32)),
    ]
    batch = inc.build_delta_batch(deltas, max_deltas=8, num_metrics=num_metrics, device=device)
    base = static.broker_valid.clone()
    # nothing is written in place: the context is the optimizer's prep
    # cache's, and the lane builds a new one from it
    return dict(fn=delta_scatter, args=(static, batch, base, base.clone()))


CCLINT_TRACE_ENTRYPOINTS = [
    # cclint: disable=trace-host-sync,trace-carry-stability -- its host round loop reads device values each round (goal_loop's satisfied and applied flags, engine's applied flag before each stall fallback, the polish pass's state fingerprints) and its rounds build tensors from Python scalars (torch.tensor, an upload on the card); they stay until the rounds are captured as CUDA graphs (ROADMAP Queue 2 item 4); the goals' costs round a*b+c once through float64 (common/xla_math.fma), bit-equal to the reference's f32 fused multiply-add; an f32 product would change decisions
    dict(name="fused-stack-step", build=_build_fused_stack),
    # cclint: disable=trace-host-sync,trace-carry-stability -- its host round loop reads device values each round (goal_loop's satisfied and applied flags, engine's applied flag before each stall fallback, the polish phases' converged flags and fingerprints, the cost-scaled round caps) and its rounds build tensors from Python scalars (torch.tensor, an upload on the card); they stay until the rounds are captured as CUDA graphs (ROADMAP Queue 2 item 4); the goals' costs round a*b+c once through float64 (common/xla_math.fma), bit-equal to the reference's f32 fused multiply-add; an f32 product would change decisions
    dict(name="chunked-goal-machine", build=_build_goal_machine),
    # cclint: disable=trace-host-sync,trace-carry-stability -- the planner reads its round gate (the largest surplus) and, once a wave, the applied and surplus counts (the `go` handoff), and builds tensors from Python scalars; they stay until the rounds are captured as CUDA graphs (ROADMAP Queue 2 item 4); the goals' costs round a*b+c once through float64 (common/xla_math.fma), bit-equal to the reference's f32 fused multiply-add; an f32 product would change decisions
    dict(name="bulk-count-round", build=_build_bulk_round),
    # cclint: disable=trace-host-sync,trace-carry-stability -- the round builds tensors from Python scalars (torch.tensor, an upload on the card); they stay until the rounds are captured as CUDA graphs (ROADMAP Queue 2 item 4); the goals' costs round a*b+c once through float64 (common/xla_math.fma), bit-equal to the reference's f32 fused multiply-add; an f32 product would change decisions
    dict(name="pair-drain-round", build=_build_pair_drain_round),
    # cclint: disable=trace-host-sync -- the round builds tensors from Python scalars (torch.tensor, an upload on the card); they stay until the rounds are captured as CUDA graphs (ROADMAP Queue 2 item 4)
    dict(name="swap-round", build=_build_swap_round),
    dict(name="sharded-compute-aggregates", build=_build_sharded_aggregates),
    # cclint: disable=trace-host-sync -- segment_sums reads the model's rack and host counts (FlatClusterModel num_racks / num_hosts) once a call; the stats run once a solve, outside the rounds
    dict(name="sharded-compute-stats", build=_build_sharded_stats),
    dict(name="spmd-grid-shortlist", build=_build_spmd_grid_shortlist),
    dict(name="spmd-partition-stats", build=_build_spmd_partition_stats),
    dict(name="incremental-delta-apply", build=_build_incremental_delta_apply),
]
