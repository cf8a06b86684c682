"""Kafka-assigner mode against the JAX package (CPU): mode detection and
goal resolution (a mirror of tests/test_swaps.py:93-106), both goals'
hooks and their K3 scores (case 15 and the DISK case, the plain version)
bit-equal to the JAX goals', and the two-goal request's solves equal to
JAX's: on tests/test_bucketing.py's 70-broker model through the fused stack
at the exact shape and bucketed, and through the chunked service machine
traced for the two goals alone (its ledger, rows and stack metrics sized to
two); the even goal alone on tests/test_swaps.py's 6-broker cluster, run
with raise_on_hard_failure=False as the JAX test runs it. No assertion reads
a clock.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import acceptance as jacc
from cruise_control_tpu.analyzer import actions as jact
from cruise_control_tpu.analyzer import context as jctx
from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer import goals as jgoals
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.analyzer import acceptance as tacc
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.analyzer import goals as tgoals
from cruise_control_torch.analyzer import optimizer as topt
from cruise_control_torch.analyzer.actions import KIND_MOVE, leadership_grid
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.kernels.score_candidates import score_candidates_plain
from cruise_control_torch.models.flat_model import from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on small tensors, where torch's intra-op
    threads buy nothing, and the suite runs in several worker processes at
    once: threads that outnumber the cores wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KA = ["KafkaAssignerEvenRackAwareGoal", "KafkaAssignerDiskUsageDistributionGoal"]
PROP = jgen.ClusterProperty(num_racks=7, num_brokers=70, num_topics=20,
                            mean_partitions_per_topic=10.0, replication_factor=2,
                            num_dead_brokers=1)
BASE = dict(batch_k=16, max_rounds_per_goal=24, num_dst_candidates=8, drain_src=128,
            apply_waves=4, ledger=True)
#: the service's settings (SERVICE_SETTINGS, bucketed), JAX's field names
SERVICE = dict(batch_k=16, max_rounds_per_goal=64, drain_src=512, drain_per_broker=8,
               drain_dst=64, apply_waves=8, bulk_waves=16, bulk_min_brokers=32,
               num_swap_pairs=8, swap_candidates=8, swaps_per_broker=4, polish_rounds=0,
               chunk_rounds=32, bucket_partitions=True, bucket_brokers=True, ledger=True,
               num_dst_candidates=8)


def _bits_equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.float32 and b.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
    return a.shape == b.shape and np.array_equal(a, b)


def test_kafka_assigner_mode_detection_and_resolution():
    for mod in (tgoals, jgoals):
        assert mod.is_kafka_assigner_mode(["KafkaAssignerEvenRackAwareGoal"])
        assert mod.is_kafka_assigner_mode(
            ["com.linkedin.kafka.cruisecontrol.analyzer.kafkaassigner."
             "KafkaAssignerDiskUsageDistributionGoal"])
        assert not mod.is_kafka_assigner_mode(["RackAwareGoal"])
        assert not mod.is_kafka_assigner_mode(None)
        goals = mod.goals_by_priority(list(reversed(KA)))
        # the rack-aware goal first in kafka-assigner mode
        assert [g.name for g in goals] == KA
        for g in mod.KAFKA_ASSIGNER_GOALS:
            assert g.name in mod.GOAL_REGISTRY
        assert [g.name for g in mod.goals_by_priority(None)] == [
            g.name for g in mod.DEFAULT_GOAL_ORDER]
    assert tgoals.GOAL_REGISTRY.keys() == jgoals.GOAL_REGISTRY.keys()
    t_even, t_disk = tgoals.KAFKA_ASSIGNER_GOALS
    assert (t_even.kernel_id, t_disk.kernel_id) == (15, 11) and t_even.is_hard
    assert t_disk.uses_swaps and not t_disk.is_hard


def test_mixing_kafka_assigner_and_regular_goals_is_refused_as_jax():
    names = ["KafkaAssignerEvenRackAwareGoal", "RackAwareGoal"]
    with pytest.raises(ValueError) as je:
        jgoals.goals_by_priority(names)
    with pytest.raises(ValueError) as te:
        tgoals.goals_by_priority(names)
    assert str(te.value) == str(je.value)
    mixed = [tgoals.KAFKA_ASSIGNER_GOALS[0], tgoals.DEFAULT_GOAL_ORDER[0]]
    with pytest.raises(ValueError, match="cannot mix"):
        topt.check_supported(mixed, topt.SERVICE_SETTINGS, tctx.OptimizationOptions())
    topt.check_supported(tgoals.KAFKA_ASSIGNER_GOALS, topt.SERVICE_SETTINGS,
                         tctx.OptimizationOptions())


@pytest.fixture(scope="module")
def ctx():
    m = jgen.random_cluster(7, PROP)
    f = {k: np.asarray(v) for k, v in m._asdict().items()}
    jd = jctx.dims_of(m)
    js = jctx.build_static_ctx(m, JConstraint.default(), jd)
    ja = jctx.compute_aggregates(js, jnp.asarray(m.assignment), jd)
    tm = from_numpy(f)
    td = tctx.dims_of(tm)
    ts = tctx.build_static_ctx(tm, TConstraint.default(), td)
    ta = tctx.compute_aggregates(ts, tm.assignment, td)
    return dict(f=f, jd=jd, js=js, ja=ja, td=td, ts=ts, ta=ta)


@pytest.mark.parametrize("gi", [0, 1], ids=KA)
def test_kafka_assigner_goal_hooks_equal_jax(ctx, gi):
    jg, tg = jgoals.KAFKA_ASSIGNER_GOALS[gi], tgoals.KAFKA_ASSIGNER_GOALS[gi]
    js, ja, ts, ta = ctx["js"], ctx["ja"], ctx["ts"], ctx["ta"]
    jgs, tgs = jg.prepare(js, ja, ctx["jd"]), tg.prepare(ts, ta, ctx["td"])
    for f in jgs._fields:
        assert _bits_equal(getattr(jgs, f), getattr(tgs, f)), f
    for h in ("broker_violation", "cost", "src_rank", "drain_contrib", "dst_preference"):
        assert _bits_equal(getattr(jg, h)(js, jgs, ja), getattr(tg, h)(ts, tgs, ta)), h
    jt = jg.contribute_acceptance(js, jgs, jacc.empty_tables(ctx["jd"]))
    tt = tg.contribute_acceptance(ts, tgs, tacc.empty_tables(ctx["td"], "cpu"))
    for f in jt._fields:
        assert _bits_equal(getattr(jt, f), getattr(tt, f)), f


@pytest.mark.parametrize("gi", [0, 1], ids=KA)
def test_k3_kafka_assigner_scores_equal_jax(ctx, gi):
    """K3's plain version on a move grid over every partition's slots and
    ten destinations, and on the promotion grid, under the priors' tables,
    against the jitted score_batch (XLA fuses its multiply-adds)."""
    jg, tg = jgoals.KAFKA_ASSIGNER_GOALS[gi], tgoals.KAFKA_ASSIGNER_GOALS[gi]
    js, ja, ts, ta = ctx["js"], ctx["ja"], ctx["ts"], ctx["ta"]
    jt = jacc.build_tables(jgoals.KAFKA_ASSIGNER_GOALS[:gi], js, ja, ctx["jd"])
    tt = tacc.build_tables(tgoals.KAFKA_ASSIGNER_GOALS[:gi], ts, ta, ctx["td"])
    jgs, tgs = jg.prepare(js, ja, ctx["jd"]), tg.prepare(ts, ta, ctx["td"])
    jscore = jax.jit(lambda act, gs, t: jacc.score_batch(js, ja, act, jg, gs, t))
    a = ctx["f"]["assignment"]
    p = np.arange(a.shape[0], dtype=np.int32)[:, None, None]
    slot = np.arange(a.shape[1], dtype=np.int32)[None, :, None]
    dst = np.random.default_rng(3).choice(70, (1, 1, 10), replace=False).astype(np.int32)
    act = jact.build_selected(js.part_load, ja.assignment, jnp.asarray(p), jnp.int32(KIND_MOVE),
                              jnp.asarray(slot), jnp.asarray(dst))
    want = np.asarray(jnp.broadcast_to(jscore(act, jgs, jt), (a.shape[0], a.shape[1], 10)))
    got = score_candidates_plain(ts, ta, tt, tg, tgs, torch.from_numpy(p), KIND_MOVE,
                                 torch.from_numpy(slot), torch.from_numpy(dst)).numpy()
    got = np.broadcast_to(got, want.shape)
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    assert _bits_equal(want[np.isfinite(want)], got[np.isfinite(got)])
    assert np.isfinite(want).sum() > 0
    lb = jact.make_leadership_batch(js.part_load, ja.assignment)
    want = np.asarray(jnp.broadcast_to(jscore(lb, jgs, jt), lb.dst.shape))
    got = score_candidates_plain(ts, ta, tt, tg, tgs, *leadership_grid(ta.assignment)).numpy()
    assert _bits_equal(np.where(np.isfinite(want), want, 0), np.where(np.isfinite(got), got, 0))


def _rows(res):
    return [(g.name, g.violated_brokers_before, g.violated_brokers_after, g.rounds, g.converged)
            for g in res.goal_results]


def _same(jres, tres):
    names = [g.name for g in jres.goal_results]
    assert tres.provenance.digest(goals=names) == jres.provenance.digest(goals=names)
    assert np.array_equal(tres.final_assignment, np.asarray(jres.final_assignment))
    assert _rows(tres) == _rows(jres)


@pytest.mark.parametrize("settings", ["exact", "bucketed", "service"])
def test_kafka_assigner_request_equals_jax(settings):
    s = {"exact": dict(BASE, bucket_partitions=False, bucket_brokers=False),
         "bucketed": dict(BASE, bucket_partitions=True, bucket_brokers=True),
         "service": SERVICE}[settings]
    jm = jgen.random_cluster(7, PROP)
    tm = from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    jres = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**s)).optimizations(
        jm, list(reversed(KA)), raise_on_hard_failure=False)
    tres = topt.GoalOptimizer(settings=topt.OptimizerSettings(**s), device="cpu").optimizations(
        tm, list(reversed(KA)), raise_on_hard_failure=False)
    _same(jres, tres)
    assert [g.name for g in tres.goal_results] == KA
    assert tres.provenance.digest(goals=KA)["byGoal"][KA[0]] > 0
    if settings == "service":
        # the machine ran the two goals alone: its ledger names them only
        assert tres.provenance.meta["goals"] == KA == jres.provenance.meta["goals"]
        assert tres.bucketed == jres.bucketed


def test_even_goal_alone_equals_jax_on_the_swap_fixture():
    """tests/test_swaps.py's kafka-assigner fixture (6 brokers, 3 racks,
    placement not rack-aware), the even goal alone with
    raise_on_hard_failure=False: equal to JAX, and the counts within one of
    the mean, as the JAX test asserts."""
    prop = jgen.ClusterProperty(num_racks=3, num_brokers=6, num_topics=6, replication_factor=2,
                                rack_aware_placement=False)
    jm = jgen.random_cluster(23, prop)
    tm = from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    s = dict(BASE, bucket_partitions=False, bucket_brokers=False)
    names = ["KafkaAssignerEvenRackAwareGoal"]
    jres = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**s)).optimizations(
        jm, names, raise_on_hard_failure=False)
    tres = topt.GoalOptimizer(settings=topt.OptimizerSettings(**s), device="cpu").optimizations(
        tm, names, raise_on_hard_failure=False)
    _same(jres, tres)
    counts = np.bincount(tres.final_assignment[tres.final_assignment >= 0], minlength=6)
    assert counts.max() <= np.ceil(counts.mean()) + 1
    assert counts.min() >= np.floor(counts.mean()) - 1
