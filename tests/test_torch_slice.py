"""The whole slice: the port's hard-goal solve on the CPU against the JAX
package's fused-stack run with the same settings, on the same models.

Fixture A is BASELINE config 1 with 2 dead brokers (rack violations and an
evacuation); fixture B is the smoke model's recipe at small size (rack-aware
placement, pareto load at mean utilisation 0.5, 2 dead brokers), where the
capacity goals that move leadership start violated. Final assignment, touch
tags, proposals and the StackMetrics integers must be equal; costs within
rtol 1e-5 (a cost is a float sum whose order may differ).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.goals import HARD_GOAL_NAMES
from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.analyzer import optimizer as topt
from cruise_control_torch.models.flat_model import from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on small tensors, where torch's intra-op
    threads buy nothing, and the suite runs in several worker processes at
    once: threads that outnumber the cores wait on each other (six 8-thread
    processes on 8 cores ran a solve 30x slower than single-thread ones)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SLICE = dict(batch_k=16, max_rounds_per_goal=64, drain_src=512, drain_per_broker=8,
             drain_dst=64, apply_waves=8, bulk_waves=0, polish_rounds=0, chunk_rounds=0,
             bucket_partitions=False, bucket_brokers=False, ledger=False)
#: the JAX side's settings: the same, with another `batch_k=1` grid width
#: (num_dst_candidates), which batch_k = 16 never reads
JAX_SLICE = dict(SLICE, num_dst_candidates=8)

FIXTURES = {
    "A": dataclasses.replace(jgen.BASELINE_CONFIGS[1], num_dead_brokers=2),
    "B": jgen.ClusterProperty(num_racks=4, num_brokers=24, num_topics=60,
                              mean_partitions_per_topic=10.0, replication_factor=3,
                              num_dead_brokers=2, load_distribution="pareto",
                              mean_utilization=0.5),
}


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def runs(request):
    """(jax model, jax result, jax final touch tags, port result) for one
    fixture; the JAX stack program compiles once and serves both JAX calls."""
    model = jgen.random_cluster(42, FIXTURES[request.param])
    settings = jopt.OptimizerSettings(**JAX_SLICE)
    jo = jopt.GoalOptimizer(settings=settings)
    jres = jo.optimizations(model, HARD_GOAL_NAMES, raise_on_hard_failure=False)
    goals, _, pmodel, dims, static, agg, _ = jo._prepare(
        model, HARD_GOAL_NAMES, jopt.OptimizationOptions())
    names = tuple(g.name for g in goals)
    step = jopt._stack_executable(names, dims, settings, None, static, agg)
    jagg, _, _ = step(static, agg)
    jtouch = np.asarray(jax.device_get(jagg.touch_tag))
    tmodel = from_numpy({k: np.asarray(v) for k, v in model._asdict().items()})
    tres = topt.GoalOptimizer(settings=topt.OptimizerSettings(**SLICE), device="cpu").optimizations(
        tmodel, HARD_GOAL_NAMES, raise_on_hard_failure=False)
    return request.param, model, jres, jtouch, tres


def test_final_assignment_equal(runs):
    _, _, jres, _, tres = runs
    assert np.array_equal(np.asarray(jres.final_assignment), tres.final_assignment)


def test_touch_tags_equal(runs):
    _, _, jres, jtouch, tres = runs
    assert tres.touch_tag.dtype == np.int32
    assert np.array_equal(jtouch, tres.touch_tag)
    # the touched cells are exactly those whose broker changed or rotated
    assert (tres.touch_tag >= 0).sum() > 0


def test_proposals_equal(runs):
    _, _, jres, _, tres = runs

    def key(prs):
        return [(p.partition, p.old_replicas, p.new_replicas, p.data_to_move_mb) for p in prs]

    assert key(jres.proposals) == key(tres.proposals)
    assert (jres.num_replica_moves, jres.num_leadership_moves) == (
        tres.num_replica_moves, tres.num_leadership_moves)


def test_stack_metrics_equal(runs):
    name, _, jres, _, tres = runs
    for jg, tg in zip(jres.goal_results, tres.goal_results, strict=True):
        assert (jg.name, jg.violated_brokers_before, jg.violated_brokers_after, jg.rounds,
                jg.converged) == (tg.name, tg.violated_brokers_before,
                                  tg.violated_brokers_after, tg.rounds, tg.converged)
        assert tg.cost_before == pytest.approx(jg.cost_before, rel=1e-5)
        assert tg.cost_after == pytest.approx(jg.cost_after, rel=1e-5)
    if name == "B":
        by = {g.name: g for g in tres.goal_results}
        assert max(by["NetworkOutboundCapacityGoal"].violated_brokers_before,
                   by["CpuCapacityGoal"].violated_brokers_before) > 0


def test_no_replica_left_on_dead_brokers(runs):
    _, model, _, _, tres = runs
    dead = np.nonzero(np.asarray(model.broker_state) == 3)[0]
    final = tres.final_assignment
    assert dead.size and not np.isin(final[final >= 0], dead).any()


def test_raise_on_hard_failure_matches(runs):
    """Where the JAX package raises OptimizationFailureException, the port
    raises its own, naming the same goal; where it does not, neither does the
    port."""
    name, model, jres, _, _ = runs
    failing = [g.name for g in jres.goal_results if g.is_hard and g.violated_brokers_after]
    tmodel = from_numpy({k: np.asarray(v) for k, v in model._asdict().items()})
    topt_ = topt.GoalOptimizer(settings=topt.OptimizerSettings(**SLICE), device="cpu")
    jopt_ = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**JAX_SLICE))
    if not failing:
        jopt_.optimizations(model, HARD_GOAL_NAMES, raise_on_hard_failure=True)
        topt_.optimizations(tmodel, HARD_GOAL_NAMES, raise_on_hard_failure=True)
        return
    with pytest.raises(jopt.OptimizationFailureException) as je:
        jopt_.optimizations(model, HARD_GOAL_NAMES, raise_on_hard_failure=True)
    with pytest.raises(topt.OptimizationFailureException) as te:
        topt_.optimizations(tmodel, HARD_GOAL_NAMES, raise_on_hard_failure=True)
    assert failing[0] in str(je.value) and failing[0] in str(te.value)
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("change, item", [
    # the batch_k=1 grid, the polish pass, the chunked machine, the ledger
    # and shape bucketing are ported (tests/test_torch_grid.py,
    # _polish.py, _service.py, _bucketing.py), and so are the options
    # (tests/test_torch_options.py); item names the ROADMAP.md item of each
    (dict(batch_k=1, bucket_brokers=True), "item 4"),
    (dict(bucket_brokers=True), "item 4"),
    (dict(bucket_partitions=True), "item 4"),
    (dict(polish_rounds=4, bucket_partitions=True), "item 4"),
    (dict(chunk_rounds=32, ledger=True, bucket_partitions=True, bucket_brokers=True), "item 4"),
    # the bulk planner in front of the batch_k=1 grid (the "bulk+grid" engine)
    (dict(bulk_waves=16, bulk_min_brokers=2, batch_k=1, bucket_brokers=True), "item 4"),
])
def test_settings_outside_the_slice_are_refused(change, item):
    """A goal-violation run under each of these settings is accepted; at the
    default multiplier (1.0) its relaxed constraint is the constraint, so it
    decides as the default options do."""
    from cruise_control_torch.analyzer.context import OptimizationOptions

    tmodel = from_numpy({k: np.asarray(v) for k, v in jgen.rack_aware_violated()._asdict().items()})
    settings = topt.OptimizerSettings(**{**SLICE, **change})
    goals = ["RackAwareGoal", "ReplicaCapacityGoal"]
    options = OptimizationOptions(is_triggered_by_goal_violation=True)
    topt.check_supported(topt.goals_by_priority(goals), settings, options)
    o = topt.GoalOptimizer(settings=settings, device="cpu")
    relaxed = o.optimizations(tmodel, goals, options, raise_on_hard_failure=False)
    plain = o.optimizations(tmodel, goals, raise_on_hard_failure=False)
    assert np.array_equal(relaxed.final_assignment, plain.final_assignment), item
    assert [(g.name, g.violated_brokers_after, g.rounds) for g in relaxed.goal_results] == [
        (g.name, g.violated_brokers_after, g.rounds) for g in plain.goal_results]


def test_soft_goals_resolve_but_are_refused():
    """The default stack's soft goals are ported, and so is the
    kafka-assigner mode's soft goal: it resolves by name and runs alone
    (tests/test_torch_kafka_assigner.py holds it to the JAX package)."""
    tmodel = from_numpy({k: np.asarray(v) for k, v in jgen.unbalanced()._asdict().items()})
    name = "KafkaAssignerDiskUsageDistributionGoal"
    res = topt.GoalOptimizer(device="cpu").optimizations(tmodel, [name],
                                                         raise_on_hard_failure=False)
    assert [g.name for g in res.goal_results] == [name]


@pytest.mark.parametrize("option, value", [
    ("excluded_partitions", None),
    ("excluded_brokers_for_leadership", None),
    ("excluded_brokers_for_replica_move", None),
    ("requested_destination_brokers", None),
    ("only_move_immigrants", True),
    ("is_triggered_by_goal_violation", True),
    ("excluded_topic_pattern", "topic-1.*"),
    ("destination_broker_ids", (0, 2)),
])
def test_options_other_than_the_defaults_are_refused(option, value):
    """Every option is accepted: the static context the optimizer prepares
    under it equals the JAX package's `build_static_ctx` under the same
    resolved option (a mask option: a seeded mask of the model's length). A
    topic pattern needs the topic names: without them both packages raise
    the same ValueError."""
    from cruise_control_tpu.analyzer import context as jctx
    from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
    from cruise_control_torch.analyzer.context import OptimizationOptions, resolve_options
    from cruise_control_torch.models.generators import topic_names

    assert {f.name for f in dataclasses.fields(OptimizationOptions)} == {
        f.name for f in dataclasses.fields(jopt.OptimizationOptions)}
    jmodel = jgen.rack_aware_violated()
    tmodel = from_numpy({k: np.asarray(v) for k, v in jmodel._asdict().items()})
    if value is None:
        n = jmodel.num_partitions if option == "excluded_partitions" else jmodel.num_brokers
        value = np.random.default_rng(3).random(n) < 0.5
    goals = ["RackAwareGoal", "ReplicaCapacityGoal"]
    o = topt.GoalOptimizer(device="cpu", settings=topt.OptimizerSettings(**SLICE))
    options = OptimizationOptions(**{option: value})
    if option == "excluded_topic_pattern":
        with pytest.raises(ValueError) as te:
            o.optimizations(tmodel, goals, options)
        with pytest.raises(ValueError) as je:
            jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**JAX_SLICE)).optimizations(
                jmodel, goals, jopt.OptimizationOptions(**{option: value}))
        assert str(te.value) == str(je.value)
        options = resolve_options(options, tmodel, topic_names(tmodel))
    static = o._prepare(tmodel, goals, options)[4]
    jopts = jctx.resolve_options(jopt.OptimizationOptions(**{option: value}), jmodel,
                                 topic_names(tmodel))
    js = jctx.build_static_ctx(jmodel, JConstraint.default(), jctx.dims_of(jmodel), jopts)
    assert static._fields == js._fields
    for field in js._fields:
        assert np.array_equal(np.asarray(getattr(js, field)),
                              getattr(static, field).numpy()), field
    res = o.optimizations(tmodel, goals, options, raise_on_hard_failure=False)
    assert [g.name for g in res.goal_results] == goals
