"""The whole 15-goal default stack: the port's CPU run against the JAX
package's fused-stack run, both with the service-default stack settings
(`optimizer.STACK_SETTINGS`), on fixture C: 32 brokers in 4 racks, 80 topics,
766 partitions at RF 3, pareto load at mean utilisation 0.5, 2 dead brokers.
32 brokers is the bulk planner's floor and the widest axis XLA:CPU sums in
index order, so every window is bit-equal (tests/test_torch_goals.py).

Final assignment, touch tags, proposals and the StackMetrics integers must
be equal; costs within rtol 1e-5 (a cost is a float sum that XLA may take in
another order inside the fused program).
"""

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as jopt
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


FIXTURE_C = jgen.ClusterProperty(num_racks=4, num_brokers=32, num_topics=80,
                                 mean_partitions_per_topic=10, replication_factor=3,
                                 num_dead_brokers=2, load_distribution="pareto",
                                 mean_utilization=0.5)
#: the JAX side's settings: STACK_SETTINGS, with another batch_k=1 grid
#: width (num_dst_candidates), which batch_k = 16 never reads
JAX_STACK = dict(batch_k=16, max_rounds_per_goal=64, drain_src=512, drain_per_broker=8,
                 drain_dst=64, apply_waves=8, bulk_waves=16, bulk_min_brokers=32,
                 num_swap_pairs=8, swap_candidates=8, swaps_per_broker=4, polish_rounds=0,
                 chunk_rounds=0, bucket_partitions=False, bucket_brokers=False, ledger=False,
                 num_dst_candidates=8)


@pytest.fixture(scope="module")
def runs():
    """(model, jax result, jax touch tags, port result); the JAX stack
    program compiles once and serves both JAX calls."""
    model = jgen.random_cluster(42, FIXTURE_C)
    settings = jopt.OptimizerSettings(**JAX_STACK)
    jo = jopt.GoalOptimizer(settings=settings)
    jres = jo.optimizations(model, None, raise_on_hard_failure=False)
    goals, _, pmodel, dims, static, agg, _ = jo._prepare(model, None, jopt.OptimizationOptions())
    step = jopt._stack_executable(tuple(g.name for g in goals), dims, settings, None, static, agg)
    jagg, _, _ = step(static, agg)
    jtouch = np.asarray(jax.device_get(jagg.touch_tag))
    tmodel = from_numpy({k: np.asarray(v) for k, v in model._asdict().items()})
    tres = topt.GoalOptimizer(settings=topt.STACK_SETTINGS, device="cpu").optimizations(
        tmodel, None, raise_on_hard_failure=False)
    return model, jres, jtouch, tres


def test_stack_settings_are_the_service_defaults():
    s = topt.STACK_SETTINGS
    for k, v in JAX_STACK.items():
        if k != "num_dst_candidates":
            assert getattr(s, k) == v, k


def test_every_goal_runs_its_reference_engine():
    from cruise_control_tpu.analyzer.context import dims_of as jdims
    from cruise_control_tpu.analyzer.goals import goals_by_priority as jgoals
    from cruise_control_torch.analyzer.context import dims_of as tdims
    from cruise_control_torch.analyzer.goals import goals_by_priority as tgoals

    model = jgen.random_cluster(42, FIXTURE_C)
    jd = jdims(model)
    td = tdims(from_numpy({k: np.asarray(v) for k, v in model._asdict().items()}))
    js = jopt.OptimizerSettings(**JAX_STACK)
    labels = [topt.goal_engine(g, td, topt.STACK_SETTINGS) for g in tgoals(None)]
    assert labels == [jopt.goal_engine(g, jd, js) for g in jgoals(None)]
    assert labels.count("bulk+drain") == 5


def test_final_assignment_equal(runs):
    _, jres, _, tres = runs
    assert np.array_equal(np.asarray(jres.final_assignment), tres.final_assignment)


def test_touch_tags_equal(runs):
    _, _, jtouch, tres = runs
    assert np.array_equal(jtouch, tres.touch_tag)
    assert (tres.touch_tag >= 0).sum() > 0


def test_proposals_equal(runs):
    _, jres, _, tres = runs

    def key(prs):
        return [(p.partition, p.old_replicas, p.new_replicas, p.data_to_move_mb) for p in prs]

    assert key(jres.proposals) == key(tres.proposals)
    assert (jres.num_replica_moves, jres.num_leadership_moves) == (
        tres.num_replica_moves, tres.num_leadership_moves)
    assert tres.num_replica_moves > 0 and tres.num_leadership_moves > 0


def test_stack_metrics_equal(runs):
    _, jres, _, tres = runs
    assert len(tres.goal_results) == 15
    for jg, tg in zip(jres.goal_results, tres.goal_results, strict=True):
        assert (jg.name, jg.violated_brokers_before, jg.violated_brokers_after, jg.rounds,
                jg.converged) == (tg.name, tg.violated_brokers_before,
                                  tg.violated_brokers_after, tg.rounds, tg.converged)
        assert tg.cost_before == pytest.approx(jg.cost_before, rel=1e-5)
        assert tg.cost_after == pytest.approx(jg.cost_after, rel=1e-5)


def test_the_soft_goals_improve_and_no_replica_is_left_on_dead_brokers(runs):
    model, _, _, tres = runs
    by = {g.name: g for g in tres.goal_results}
    assert by["ReplicaDistributionGoal"].violated_brokers_after < by[
        "ReplicaDistributionGoal"].violated_brokers_before
    assert by["TopicReplicaDistributionGoal"].cost_after < by[
        "TopicReplicaDistributionGoal"].cost_before
    dead = np.nonzero(np.asarray(model.broker_state) == 3)[0]
    final = tres.final_assignment
    assert dead.size and not np.isin(final[final >= 0], dead).any()
