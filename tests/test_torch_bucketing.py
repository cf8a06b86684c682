"""Shape bucketing and the prep cache: the port's padding helpers
(cruise_control_torch/parallel/sharding.py), `build_static_ctx` with the
real counts, and a bucketed solve, against the JAX package on the same
numpy inputs (CPU).

The model is tests/test_bucketing.py's: 70 brokers in 7 racks (one dead),
20 topics, 190 partitions at RF 2, so the broker axis pads to 80 and the
partition axis to 192. The solve runs the four goal families of that module
under its settings, with the ledger, on the fused stack: the JAX package
compiles one program for the module. Integers and decision digests are
compared exactly, floats bit for bit. No assertion reads a clock.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as jctx
from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.stats import stats_to_dict as jstats_to_dict
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.models import generators as jgen
from cruise_control_tpu.parallel import sharding as jsh
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.analyzer import optimizer as topt
from cruise_control_torch.analyzer.stats import stats_to_dict
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.models.flat_model import from_numpy
from cruise_control_torch.parallel import sharding as tsh


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on small tensors, where torch's intra-op
    threads buy nothing, and the suite runs in several worker processes at
    once: threads that outnumber the cores wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: tests/test_bucketing.py's model, goals and settings
PROP = jgen.ClusterProperty(num_racks=7, num_brokers=70, num_topics=20,
                            mean_partitions_per_topic=10.0, replication_factor=2,
                            num_dead_brokers=1)
GOALS = ["RackAwareGoal", "ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "LeaderReplicaDistributionGoal"]
BASE = dict(batch_k=16, max_rounds_per_goal=24, num_dst_candidates=8, drain_src=128,
            apply_waves=4)


def _arrays():
    return {k: np.asarray(v) for k, v in jgen.random_cluster(7, PROP)._asdict().items()}


def _bits_equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _models_equal(jm, tm):
    return all(_bits_equal(getattr(jm, f), getattr(tm, f)) for f in tm._fields)


# -- the padding helpers ---------------------------------------------------------


@pytest.mark.parametrize("n", [1, 20, 32, 33, 63, 64, 65, 70, 80, 81, 127, 128, 129, 190, 193,
                               500, 2570, 2600, 3072, 3073, 4000, 199_518, 212_992])
def test_bucket_ladders_equal_jax(n):
    assert tsh.geom_bucket(n) == jsh.geom_bucket(n)
    assert tsh.size_bucket(n) == jsh.size_bucket(n) == tsh.partition_bucket(n)
    for ratio, floor in ((1.125, 32), (1.25, 16), (1.5, 64)):
        assert tsh.geom_bucket(n, ratio, floor) == jsh.geom_bucket(n, ratio, floor)


def test_smoke_model_buckets():
    """The smoke model's padded axes (2,600 brokers, 4,000 topics, 199,518
    partitions; 52 racks stay exact below the floor)."""
    assert (tsh.geom_bucket(2600), tsh.partition_bucket(4000), tsh.partition_bucket(199_518),
            tsh.geom_bucket(52)) == (3072, 4096, 212_992, 52)


@pytest.mark.parametrize("target", [190, 192, 200, 256])
def test_pad_partitions_to_equals_jax(target):
    arrays = _arrays()
    jm = jsh.pad_partitions_to(jgen.random_cluster(7, PROP), target)
    tm = tsh.pad_partitions_to(from_numpy(arrays), target)
    assert _models_equal(jm, tm)
    assert tm.num_partitions == max(target, 190)


@pytest.mark.parametrize("target, racks, hosts", [
    (80, 8, 80),  # padded rack and host ids
    (80, 7, 70),  # round-robin over the real racks and hosts
    (96, 7, 80),
    (70, 7, 70),  # nothing to pad
])
def test_pad_brokers_to_equals_jax(target, racks, hosts):
    jm = jsh.pad_brokers_to(jgen.random_cluster(7, PROP), target, racks, hosts)
    tm = tsh.pad_brokers_to(from_numpy(_arrays()), target, racks, hosts)
    assert _models_equal(jm, tm)
    assert (tm.broker_state[70:] == 3).all() and (tm.broker_capacity[70:] == 0).all()


# -- the static context with real counts -----------------------------------------


def _padded_pair():
    jm = jgen.random_cluster(7, PROP)
    jm = jsh.pad_brokers_to(jsh.pad_partitions_to(jm, 192), 80, 7, 80)
    tm = tsh.pad_brokers_to(tsh.pad_partitions_to(from_numpy(_arrays()), 192), 80, 7, 80)
    return jm, tm


@pytest.mark.parametrize("valid", [(None, None), (70, 190), (70, None), (None, 190)],
                         ids=["no-counts", "both", "brokers", "partitions"])
def test_build_static_ctx_with_valid_counts_equals_jax(valid):
    jm, tm = _padded_pair()
    jd, td = jctx.dims_of(jm), tctx.dims_of(tm)
    assert dataclasses.asdict(jd) == dataclasses.asdict(td)
    js = jctx.build_static_ctx(jm, JConstraint.default(), jd, valid_brokers=valid[0],
                               valid_partitions=valid[1])
    ts = tctx.build_static_ctx(tm, TConstraint.default(), td, valid_brokers=valid[0],
                               valid_partitions=valid[1])
    for f in ts._fields:
        assert _bits_equal(js._asdict()[f], getattr(ts, f)), f
    if valid[0] is not None:
        # padded brokers are neither alive nor dead, and never destinations
        for f in ("broker_valid", "alive", "dead", "replica_dst_ok", "leadership_dst_ok"):
            assert not getattr(ts, f)[70:].any(), f


# -- the bucketed solve ------------------------------------------------------------


@pytest.fixture(scope="module")
def solves():
    """JAX's bucketed solve, the port's (cold), the port's again on the same
    model objects (a prep-cache hit) and the port's on a fresh optimizer."""
    jres = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**BASE)).optimizations(
        jgen.random_cluster(7, PROP), GOALS, raise_on_hard_failure=False)
    opt = topt.GoalOptimizer(settings=topt.OptimizerSettings(**BASE), device="cpu")
    tm = from_numpy(_arrays())
    cold = opt.optimizations(tm, GOALS, raise_on_hard_failure=False)
    entry = opt.prepared_entry(tm, tctx.OptimizationOptions())
    hit = opt.optimizations(tm, GOALS, raise_on_hard_failure=False)
    fresh = topt.GoalOptimizer(settings=topt.OptimizerSettings(**BASE), device="cpu")
    return dict(jres=jres, cold=cold, hit=hit, opt=opt, tm=tm, entry=entry,
                again=fresh.optimizations(from_numpy(_arrays()), GOALS,
                                          raise_on_hard_failure=False))


def test_both_axes_really_pad(solves):
    for res in (solves["jres"], solves["cold"]):
        assert res.bucketed["paddedBrokers"] == 10 and res.bucketed["paddedPartitions"] == 2
        assert res.bucketed["bucket"] == "P192-B80-T20-RF2"


def test_bucketed_solve_equals_jax(solves):
    jres, tres = solves["jres"], solves["cold"]
    assert tres.bucketed == jres.bucketed
    assert np.array_equal(np.asarray(jres.final_assignment), tres.final_assignment)
    assert tres.final_assignment.shape == (190, 2) and tres.touch_tag.shape == (190, 2)
    assert tres.provenance.digest(goals=GOALS) == jres.provenance.digest(goals=GOALS)
    assert tres.provenance.meta["bucket"] == jres.provenance.meta["bucket"]
    assert [(g.name, g.violated_brokers_before, g.violated_brokers_after, g.rounds, g.converged)
            for g in tres.goal_results] == [
        (g.name, g.violated_brokers_before, g.violated_brokers_after, g.rounds, g.converged)
        for g in jres.goal_results]


def test_bucketed_proposals_and_stats_equal_jax(solves):
    jres, tres = solves["jres"], solves["cold"]

    def key(prs):
        return [(p.partition, p.old_replicas, p.new_replicas, p.data_to_move_mb) for p in prs]

    assert key(tres.proposals) == key(jres.proposals) and tres.proposals
    assert stats_to_dict(tres.stats_before) == jstats_to_dict(jres.stats_before)
    assert stats_to_dict(tres.stats_after) == jstats_to_dict(jres.stats_after)


@pytest.mark.parametrize("other", ["hit", "again"])
def test_prep_cache_hit_equals_cold_solve(solves, other):
    cold, res = solves["cold"], solves[other]
    assert np.array_equal(cold.final_assignment, res.final_assignment)
    assert np.array_equal(cold.touch_tag, res.touch_tag)
    assert res.provenance.digest(goals=GOALS) == cold.provenance.digest(goals=GOALS)
    assert res.bucketed == cold.bucketed


def test_prep_cache_hit_reuses_the_entry(solves):
    opt, tm = solves["opt"], solves["tm"]
    assert len(opt._prep_cache) == 1
    entry = opt.prepared_entry(tm, tctx.OptimizationOptions())
    assert all(x is y for x, y in zip(entry, solves["entry"]))
    p_orig, pmodel, dims, static, static_canon, bucketed = entry
    assert (p_orig, pmodel.num_partitions, pmodel.num_brokers) == (190, 192, 80)
    assert static is static_canon and bucketed["bucket"] == topt.bucket_label(dims)
    # another model object with the same values is another key
    assert opt.prepared_entry(from_numpy(_arrays()), tctx.OptimizationOptions()) is None


def test_prepare_key_has_jax_fields():
    arrays = _arrays()
    jm = jgen.random_cluster(7, PROP)._replace(**arrays)
    tm = from_numpy(arrays)
    for opts in (tctx.OptimizationOptions(),
                 tctx.OptimizationOptions(only_move_immigrants=True, destination_broker_ids=(1,))):
        jopts = jopt.OptimizationOptions(**dataclasses.asdict(opts))
        tkey = topt.GoalOptimizer._prepare_key(tm, opts)
        jkey = jopt.GoalOptimizer._prepare_key(jm, jopts)
        assert len(tkey) == len(jkey) == len(tm._fields) + len(dataclasses.fields(opts))
        assert tkey[:len(tm._fields)] == tuple(id(t) for t in tm)
        assert tkey[len(tm._fields):] == jkey[len(jm._fields):]
    mask = np.zeros(70, dtype=bool)
    keyed = topt.GoalOptimizer._prepare_key(tm, tctx.OptimizationOptions(
        excluded_brokers_for_leadership=mask))
    assert ("id", id(mask)) in keyed


def test_prep_cache_keeps_two_entries():
    opt = topt.GoalOptimizer(settings=topt.OptimizerSettings(**BASE), device="cpu")
    models = [from_numpy(_arrays()) for _ in range(3)]
    for m in models:
        opt.optimizations(m, [], raise_on_hard_failure=False)
    opts = tctx.OptimizationOptions()
    assert opt.prepared_entry(models[0], opts) is None
    assert opt.prepared_entry(models[1], opts) is not None
    assert opt.prepared_entry(models[2], opts) is not None


def test_empty_goal_list_is_cut_to_the_real_partitions():
    res = topt.GoalOptimizer(settings=topt.OptimizerSettings(**BASE), device="cpu").optimizations(
        from_numpy(_arrays()), [])
    assert res.final_assignment.shape == (190, 2) and res.bucketed["paddedBrokers"] == 10


def test_warmup_prepares_the_model_and_changes_no_decision(solves):
    """The service's warm-up (one budget-1 machine call) leaves the prep-cache
    entry, and the solve after it equals the cold solve."""
    settings = dataclasses.replace(topt.SERVICE_SETTINGS, **BASE)
    opt = topt.GoalOptimizer(settings=settings, device="cpu")
    tm = from_numpy(_arrays())
    assert opt.warmup(tm, GOALS) >= 0.0
    assert opt.prepared_entry(tm, tctx.OptimizationOptions()) is not None
    res = opt.optimizations(tm, GOALS, raise_on_hard_failure=False)
    assert len(opt._prep_cache) == 1
    assert np.array_equal(res.final_assignment, solves["cold"].final_assignment)
    assert res.provenance.digest(goals=GOALS) == solves["cold"].provenance.digest(goals=GOALS)


def test_settings_with_bucketing():
    s = topt.SERVICE_SETTINGS
    assert s.bucket_partitions and s.bucket_brokers and (s.bucket_ratio, s.bucket_floor) == (
        1.25, 64)
    assert dataclasses.replace(s, bucket_partitions=False, bucket_brokers=False) == \
        topt.SERVICE_EXACT_SETTINGS
    assert dataclasses.replace(topt.BENCH_BUCKETED_SETTINGS, bucket_partitions=False,
                               bucket_brokers=False) == topt.BENCH_SETTINGS
    for f in ("bucket_ratio", "bucket_floor", "bucket_partitions", "bucket_brokers",
              "chunk_target_s"):
        assert getattr(topt.OptimizerSettings(), f) == getattr(jopt.OptimizerSettings(), f), f
    topt.check_supported(topt.goals_by_priority(None), s, tctx.OptimizationOptions())


def test_bucket_label_equals_jax():
    d = tctx.Dims(212_992, 3, 3072, 52, 3072, 4096)
    jd = jctx.Dims(**dataclasses.asdict(d))
    assert topt.bucket_label(d) == jopt.bucket_label(jd) == "P212992-B3072-T4096-RF3"


def test_static_ctx_of_the_prepared_entry_equals_jax(solves):
    """The entry's padded model and static context equal the JAX package's
    _build_ctx on the same model, field for field."""
    jo = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**BASE))
    jp_orig, jpm, jdims, jstatic, _, jbucketed = jo._build_ctx(
        jgen.random_cluster(7, PROP), jopt.OptimizationOptions())
    p_orig, pm, dims, static, _, bucketed = solves["entry"]
    assert (p_orig, dataclasses.asdict(dims), bucketed) == (
        jp_orig, dataclasses.asdict(jdims), jbucketed)
    assert _models_equal(jpm, pm)
    for f in static._fields:
        assert _bits_equal(jnp.asarray(jstatic._asdict()[f]), getattr(static, f)), f


@pytest.mark.parametrize("tick", [1e-6, 1.0, 1e3], ids=["fast-clock", "one-second", "slow-clock"])
def test_a_pinned_chunk_target_fixes_the_call_schedule(tick, monkeypatch):
    """With a huge `chunk_target_s` every machine call's budget is 8x the
    last (back to `chunk_rounds` at a goal boundary), whatever the clock
    reads between calls."""
    budgets = []
    inner = topt._make_goal_machine

    def logged(goals, dims, settings):
        machine = inner(goals, dims, settings)

        def call(*args):
            budgets.append(args[7])
            return machine(*args)

        call.n_phases = machine.n_phases
        return call

    clock = iter(range(10**6))
    monkeypatch.setattr(topt, "_make_goal_machine", logged)
    monkeypatch.setattr(topt.time, "monotonic", lambda: next(clock) * tick)
    settings = dataclasses.replace(topt.SERVICE_SETTINGS, **BASE, chunk_rounds=2,
                                   chunk_target_s=1e9)
    topt.GoalOptimizer(settings=settings, device="cpu").optimizations(
        from_numpy(_arrays()), GOALS, raise_on_hard_failure=False)
    assert budgets[0] == 2 and len(budgets) > 3
    assert all(b in (2, min(4096, 8 * a)) for a, b in zip(budgets, budgets[1:]))
