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
    # _polish.py, _service.py, _bucketing.py); an option other than the
    # defaults, also with them, is still refused
    (dict(batch_k=1, bucket_brokers=True), "item 4"),
    (dict(bucket_brokers=True), "item 4"),
    (dict(bucket_partitions=True), "item 4"),
    (dict(polish_rounds=4, bucket_partitions=True), "item 4"),
    (dict(chunk_rounds=32, ledger=True, bucket_partitions=True, bucket_brokers=True), "item 4"),
    # the bulk planner in front of the batch_k=1 grid (the "bulk+grid" engine)
    (dict(bulk_waves=16, bulk_min_brokers=2, batch_k=1, bucket_brokers=True), "item 4"),
])
def test_settings_outside_the_slice_are_refused(change, item):
    from cruise_control_torch.analyzer.context import OptimizationOptions

    tmodel = from_numpy({k: np.asarray(v) for k, v in jgen.rack_aware_violated()._asdict().items()})
    settings = topt.OptimizerSettings(**{**SLICE, **change})
    goals = ["RackAwareGoal", "ReplicaCapacityGoal"]
    topt.check_supported(topt.goals_by_priority(goals), settings, OptimizationOptions())
    with pytest.raises(NotImplementedError, match=item):
        topt.GoalOptimizer(settings=settings, device="cpu").optimizations(
            tmodel, goals, OptimizationOptions(is_triggered_by_goal_violation=True))


def test_soft_goals_resolve_but_are_refused():
    """The default stack's soft goals are ported; the kafka-assigner mode's
    soft goal still resolves by name and is refused."""
    tmodel = from_numpy({k: np.asarray(v) for k, v in jgen.unbalanced()._asdict().items()})
    name = "KafkaAssignerDiskUsageDistributionGoal"
    with pytest.raises(NotImplementedError, match=f"{name} .*item 6"):
        topt.GoalOptimizer(device="cpu").optimizations(tmodel, [name])


@pytest.mark.parametrize("option, value", [
    ("excluded_partitions", np.zeros(1, dtype=bool)),
    ("excluded_brokers_for_leadership", np.zeros(1, dtype=bool)),
    ("excluded_brokers_for_replica_move", np.zeros(1, dtype=bool)),
    ("requested_destination_brokers", np.ones(1, dtype=bool)),
    ("only_move_immigrants", True),
    ("is_triggered_by_goal_violation", True),
    ("excluded_topic_pattern", "t.*"),
    ("destination_broker_ids", (0,)),
])
def test_options_other_than_the_defaults_are_refused(option, value):
    """The port takes the default OptimizationOptions only; any other value
    is refused by name, not applied untested."""
    from cruise_control_torch.analyzer.context import OptimizationOptions

    assert {f.name for f in dataclasses.fields(OptimizationOptions)} == {
        f.name for f in dataclasses.fields(jopt.OptimizationOptions)}
    tmodel = from_numpy({k: np.asarray(v) for k, v in jgen.rack_aware_violated()._asdict().items()})
    options = OptimizationOptions(**{option: value})
    with pytest.raises(NotImplementedError, match=f"option {option} .*item 4"):
        topt.GoalOptimizer(device="cpu").optimizations(
            tmodel, ["RackAwareGoal", "ReplicaCapacityGoal"], options)
