"""The request options against the JAX package (CPU): each
OptimizationOptions field alone, at the exact shape and bucketed, through
the fused stack of four goal families (rack awareness, replica counts, disk
usage with its replica swaps, leader counts), on tests/test_bucketing.py's
70-broker model (7 racks, one dead broker, 20 topics, 190 partitions at RF
2; bucketed to 80 brokers and 192 partitions):

- excluded_partitions (a seeded tenth of the partitions),
- excluded_topic_pattern (topic-10 .. topic-19, resolved against the
  generator's `topic-<t>` names),
- destination_broker_ids (ten alive brokers),
- excluded_brokers_for_replica_move (the same ten),
- excluded_brokers_for_leadership (six brokers, marked DEMOTED),
- only_move_immigrants (three more brokers dead),
- is_triggered_by_goal_violation (the constraint's multiplier at 2.5).

Each solve's decision digest, final assignment, proposals and goal rows
equal the JAX run's. Then only_move_immigrants under the batch_k=1 grid
(K9's path), and the incremental lane armed on a solve with options: its
proposal equals the JAX lane's, and a partition add under an exclusion mask
falls back as JAX's does. The JAX package compiles one fused program per
shape and settings; the options are run-time arrays. No assertion reads a
clock.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import context as jctx
from cruise_control_tpu.analyzer import incremental as jinc
from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.analyzer import incremental as tinc
from cruise_control_torch.analyzer import optimizer as topt
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.models.flat_model import from_numpy
from cruise_control_torch.models.generators import topic_names


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on small tensors, where torch's intra-op
    threads buy nothing, and the suite runs in several worker processes at
    once: threads that outnumber the cores wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PROP = jgen.ClusterProperty(num_racks=7, num_brokers=70, num_topics=20,
                            mean_partitions_per_topic=10.0, replication_factor=2,
                            num_dead_brokers=1)
GOALS = ["RackAwareGoal", "ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "LeaderReplicaDistributionGoal"]
BASE = dict(batch_k=16, max_rounds_per_goal=24, num_dst_candidates=8, drain_src=128,
            apply_waves=4, ledger=True)
#: the batch_k=1 grid under bench.py's greedy settings, fused
GREEDY = dict(num_dst_candidates=16, num_swap_pairs=16, swap_candidates=16, swaps_per_broker=4,
              batch_k=1, max_rounds_per_goal=512, cost_scaled_rounds=1.5, rounds_ceiling=4096,
              bucket_partitions=False, bucket_brokers=False, ledger=True)
MULTIPLIER = 2.5


def _arrays():
    return {k: np.asarray(v).copy() for k, v in jgen.random_cluster(7, PROP)._asdict().items()}


def _group(n: int, seed: int = 11) -> np.ndarray:
    f = _arrays()
    alive = np.nonzero(f["broker_state"] != 3)[0]
    return np.random.default_rng(seed).choice(alive, n, replace=False)


def _mask(ids, b: int = 70) -> np.ndarray:
    m = np.zeros(b, dtype=bool)
    m[ids] = True
    return m


def _with_state(f, ids, value):
    st = f["broker_state"].copy()
    st[ids] = value
    return dict(f, broker_state=st)


def _case(name):
    """(model fields, OptimizationOptions keyword arguments, multiplier)."""
    f = _arrays()
    grp = _group(20)
    return {
        "excluded_partitions": (
            f, dict(excluded_partitions=np.random.default_rng(11).random(190) < 0.1), 1.0),
        "excluded_topic_pattern": (f, dict(excluded_topic_pattern=r"topic-1\d"), 1.0),
        "destination_broker_ids": (
            f, dict(destination_broker_ids=tuple(int(b) for b in grp[:10])), 1.0),
        "excluded_brokers_for_replica_move": (
            f, dict(excluded_brokers_for_replica_move=_mask(grp[:10])), 1.0),
        "excluded_brokers_for_leadership": (
            _with_state(f, grp[:6], 2), dict(excluded_brokers_for_leadership=_mask(grp[:6])),
            1.0),
        "only_move_immigrants": (_with_state(f, grp[:3], 3), dict(only_move_immigrants=True),
                                 1.0),
        "is_triggered_by_goal_violation": (
            f, dict(is_triggered_by_goal_violation=True), MULTIPLIER),
    }[name]


CASES = ("excluded_partitions", "excluded_topic_pattern", "destination_broker_ids",
         "excluded_brokers_for_replica_move", "excluded_brokers_for_leadership",
         "only_move_immigrants", "is_triggered_by_goal_violation")


def _solve_both(fields, okw, multiplier, settings, goals=GOALS):
    """(jax result, port result, resolved port options, port model)."""
    jm = jgen.random_cluster(7, PROP)._replace(**fields)
    tm = from_numpy(fields)
    names = topic_names(tm)
    jc = dataclasses.replace(JConstraint.default(),
                             goal_violation_distribution_threshold_multiplier=multiplier)
    tc = dataclasses.replace(TConstraint.default(),
                             goal_violation_distribution_threshold_multiplier=multiplier)
    jres = jopt.GoalOptimizer(constraint=jc, settings=jopt.OptimizerSettings(**settings)) \
        .optimizations(jm, goals, jctx.resolve_options(jctx.OptimizationOptions(**okw), jm, names),
                       raise_on_hard_failure=False)
    topts = tctx.resolve_options(tctx.OptimizationOptions(**okw), tm, names)
    tres = topt.GoalOptimizer(constraint=tc, settings=topt.OptimizerSettings(**settings),
                              device="cpu").optimizations(tm, goals, topts,
                                                          raise_on_hard_failure=False)
    return jres, tres, topts, tm


@pytest.fixture(scope="module")
def solves():
    cache = {}

    def get(name, bucketed):
        key = (name, bucketed)
        if key not in cache:
            settings = dict(BASE, bucket_partitions=bucketed, bucket_brokers=bucketed)
            cache[key] = _solve_both(*_case(name), settings)
        return cache[key]

    return get


def _rows(res):
    return [(g.name, g.violated_brokers_before, g.violated_brokers_after, g.rounds, g.converged)
            for g in res.goal_results]


def _same_decisions(jres, tres):
    names = [g.name for g in jres.goal_results]
    assert tres.provenance.digest(goals=names) == jres.provenance.digest(goals=names)
    assert np.array_equal(tres.final_assignment, np.asarray(jres.final_assignment))
    assert _rows(tres) == _rows(jres)
    assert [(p.partition, p.old_replicas, p.new_replicas) for p in tres.proposals] == [
        (p.partition, p.old_replicas, p.new_replicas) for p in jres.proposals]


@pytest.mark.parametrize("bucketed", [False, True], ids=["exact", "bucketed"])
@pytest.mark.parametrize("name", CASES)
def test_option_alone_equals_jax(solves, name, bucketed):
    jres, tres = solves(name, bucketed)[:2]
    _same_decisions(jres, tres)
    assert tres.provenance.digest(goals=GOALS)["moves"] > 0
    if bucketed:
        assert tres.bucketed == jres.bucketed and tres.bucketed["paddedBrokers"] == 10


@pytest.mark.parametrize("bucketed", [False, True], ids=["exact", "bucketed"])
def test_options_hold_in_the_final_assignment(solves, bucketed):
    """What each option forbids did not happen: excluded partitions keep
    their rows, only the requested brokers (and no excluded one) gained
    replicas, no leadership transfer went to an excluded (demoted) broker,
    only replicas of dead brokers moved."""
    f = _arrays()
    grp = _group(20)
    init = f["assignment"]

    def gained(final):
        return {int(b) for p in range(init.shape[0])
                for b in set(final[p][final[p] >= 0]) - set(init[p][init[p] >= 0])}

    for name in ("excluded_partitions", "excluded_topic_pattern"):
        _, tres, topts, _ = solves(name, bucketed)
        keep = np.asarray(topts.excluded_partitions)
        assert keep.any() and np.array_equal(tres.final_assignment[keep], init[keep]), name
    assert gained(solves("destination_broker_ids", bucketed)[1].final_assignment) <= set(
        grp[:10].tolist())
    assert not gained(solves("excluded_brokers_for_replica_move", bucketed)[1]
                      .final_assignment) & set(grp[:10].tolist())
    final = solves("excluded_brokers_for_leadership", bucketed)[1].final_assignment
    # a leadership transfer keeps the row's brokers and changes its leader
    promoted = {int(final[p, 0]) for p in range(init.shape[0])
                if final[p, 0] != init[p, 0] and set(final[p]) == set(init[p])}
    assert promoted and not promoted & set(grp[:6].tolist())
    _, tres, _, tm = solves("only_move_immigrants", bucketed)
    dead = set(np.nonzero(tm.broker_state.numpy() == 3)[0].tolist())
    for p in range(init.shape[0]):
        left = set(init[p][init[p] >= 0]) - set(tres.final_assignment[p])
        assert left <= dead, p


def test_the_multiplier_relaxes_the_constraint_as_jax():
    jc = dataclasses.replace(JConstraint.default(),
                             goal_violation_distribution_threshold_multiplier=MULTIPLIER)
    tc = dataclasses.replace(TConstraint.default(),
                             goal_violation_distribution_threshold_multiplier=MULTIPLIER)
    jr, tr = jc.with_multiplier_applied(), tc.with_multiplier_applied()
    assert jr.resource_balance_percentage.dtype == tr.resource_balance_percentage.dtype
    assert np.array_equal(jr.resource_balance_percentage.view(np.int32),
                          tr.resource_balance_percentage.view(np.int32))
    for f in ("replica_balance_percentage", "leader_replica_balance_percentage",
              "topic_replica_balance_percentage"):
        assert getattr(jr, f) == getattr(tr, f) and getattr(tr, f) != getattr(tc, f), f
    # at the default multiplier nothing changes
    d = TConstraint.default().with_multiplier_applied()
    assert d.replica_balance_percentage == TConstraint.default().replica_balance_percentage


@pytest.mark.parametrize("bucketed", [False, True], ids=["exact", "bucketed"])
def test_static_ctx_under_every_option_equals_jax(bucketed):
    """The prepared static context under all the options at once equals the
    JAX package's `_build_ctx`: padded partitions excluded, padded brokers
    in no broker mask, the relaxed thresholds, the immigrant flag."""
    f = _arrays()
    grp = _group(20)
    okw = dict(excluded_partitions=np.random.default_rng(11).random(190) < 0.1,
               excluded_brokers_for_leadership=_mask(grp[:6]),
               excluded_brokers_for_replica_move=_mask(grp[6:10]),
               destination_broker_ids=tuple(int(b) for b in grp[10:]),
               only_move_immigrants=True, is_triggered_by_goal_violation=True)
    settings = dict(BASE, bucket_partitions=bucketed, bucket_brokers=bucketed)
    jc = dataclasses.replace(JConstraint.default(),
                             goal_violation_distribution_threshold_multiplier=MULTIPLIER)
    tc = dataclasses.replace(TConstraint.default(),
                             goal_violation_distribution_threshold_multiplier=MULTIPLIER)
    js = jopt.GoalOptimizer(constraint=jc, settings=jopt.OptimizerSettings(**settings))._build_ctx(
        jgen.random_cluster(7, PROP), jctx.OptimizationOptions(**okw))[3]
    ts = topt.GoalOptimizer(constraint=tc, settings=topt.OptimizerSettings(**settings),
                            device="cpu")._build_ctx(from_numpy(f),
                                                     tctx.OptimizationOptions(**okw))[3]
    assert ts._fields == js._fields
    for field in ts._fields:
        j, t = np.asarray(getattr(js, field)), getattr(ts, field).numpy()
        assert j.shape == t.shape and np.array_equal(
            j.view(np.int32) if j.dtype == np.float32 else j,
            t.view(np.int32) if t.dtype == np.float32 else t), field
    assert bool(ts.only_move_immigrants)
    if bucketed:
        assert not ts.movable_partition[190:].any() and not ts.replica_dst_ok[70:].any()


def test_destination_ids_out_of_range_raise_as_jax():
    f = _arrays()
    options = dict(destination_broker_ids=(3, 70, -1))
    with pytest.raises(ValueError) as je:
        jctx.resolve_options(jctx.OptimizationOptions(**options), jgen.random_cluster(7, PROP))
    with pytest.raises(ValueError) as te:
        tctx.resolve_options(tctx.OptimizationOptions(**options), from_numpy(f))
    assert str(te.value) == str(je.value) and "[70, -1]" in str(te.value)
    # the optimizer resolves broker ids itself, and raises the same
    with pytest.raises(ValueError, match="out of range"):
        topt.GoalOptimizer(device="cpu", settings=topt.OptimizerSettings(**BASE)).optimizations(
            from_numpy(f), GOALS, tctx.OptimizationOptions(**options))


def test_resolve_options_equals_jax():
    f = _arrays()
    tm, jm = from_numpy(f), jgen.random_cluster(7, PROP)
    names = topic_names(tm)
    assert names == jgen.metadata_for(jm).topic_names
    given = np.random.default_rng(5).random(190) < 0.05
    req = np.random.default_rng(6).random(70) < 0.5
    okw = dict(excluded_topic_pattern=r"topic-(3|1\d)", excluded_partitions=given,
               destination_broker_ids=(1, 2, 3, 40), requested_destination_brokers=req)
    jr = jctx.resolve_options(jctx.OptimizationOptions(**okw), jm, names)
    tr = tctx.resolve_options(tctx.OptimizationOptions(**okw), tm, names)
    for field in dataclasses.fields(tr):
        j, t = getattr(jr, field.name), getattr(tr, field.name)
        assert (j is None and t is None) or np.array_equal(np.asarray(j), np.asarray(t)), field
    assert tr.excluded_topic_pattern is None and tr.destination_broker_ids is None


def test_only_move_immigrants_under_the_greedy_grid_equals_jax():
    """K9's path: the batch_k=1 grid's shortlist and its waves carry the
    immigrant term."""
    jres, tres = _solve_both(*_case("only_move_immigrants"), GREEDY)[:2]
    _same_decisions(jres, tres)
    assert tres.provenance.digest(goals=GOALS)["moves"] > 0


# -- the incremental lane armed with options -----------------------------------------


LANE_OPTIONS = dict(is_triggered_by_goal_violation=True)


@pytest.fixture(scope="module")
def armed_solves():
    """Both packages' bucketed fused solve under the lane's options (the
    goal-violation multiplier and ten brokers excluded from replica moves),
    with the optimizers and the options objects the lanes arm on."""
    settings = dict(BASE, bucket_partitions=True, bucket_brokers=True)
    grp = _group(20)
    jm, tm = jgen.random_cluster(7, PROP), from_numpy(_arrays())
    jc = dataclasses.replace(JConstraint.default(),
                             goal_violation_distribution_threshold_multiplier=MULTIPLIER)
    tc = dataclasses.replace(TConstraint.default(),
                             goal_violation_distribution_threshold_multiplier=MULTIPLIER)
    okw = dict(LANE_OPTIONS, excluded_brokers_for_replica_move=_mask(grp[:10]))
    jo = jopt.GoalOptimizer(constraint=jc, settings=jopt.OptimizerSettings(**settings))
    to = topt.GoalOptimizer(constraint=tc, settings=topt.OptimizerSettings(**settings),
                            device="cpu")
    jopts, topts = jctx.OptimizationOptions(**okw), tctx.OptimizationOptions(**okw)
    jfull = jo.optimizations(jm, GOALS, jopts, raise_on_hard_failure=False)
    tfull = to.optimizations(tm, GOALS, topts, raise_on_hard_failure=False)
    return dict(jm=jm, tm=tm, jo=jo, to=to, jopts=jopts, topts=topts, jfull=jfull,
                tfull=tfull, grp=grp)


def test_lane_with_options_equals_jax_lane(armed_solves):
    s = armed_solves
    _same_decisions(s["jfull"], s["tfull"])
    jl, tl = jinc.IncrementalLane(s["jo"]), tinc.IncrementalLane(s["to"])
    assert jl.arm(s["jm"], s["jopts"], GOALS, generation=1)
    assert tl.arm(s["tm"], s["topts"], GOALS, generation=1)
    # the armed base masks leave the excluded brokers out
    excluded = torch.from_numpy(_mask(s["grp"][:10], 80))
    assert not (tl._armed.base_replica_dst & excluded).any()
    f = _arrays()
    st = f["broker_state"].copy()
    st[int(s["grp"][15])] = 3
    new = dict(f, broker_state=st)
    jout = jl.propose(s["jm"]._replace(**new), generation=2)
    tout = tl.propose(from_numpy(new), generation=2)
    assert jout.ok and tout.ok and tout.affected == jout.affected
    goals = list(tout.affected)
    assert tout.result.provenance.digest(goals=goals) == jout.result.provenance.digest(goals=goals)
    assert np.array_equal(tout.result.final_assignment, np.asarray(jout.result.final_assignment))
    # the scattered context keeps the run's flag and relaxed thresholds
    assert torch.equal(tl._armed.static.replica_balance_pct,
                       s["to"].prepared_entry(s["tm"], s["topts"])[3].replica_balance_pct)
    gained = {int(b) for b in np.unique(tout.result.final_assignment)} - {
        int(b) for b in np.unique(f["assignment"])}
    assert not gained & set(s["grp"][:10].tolist())


def test_lane_partition_add_under_an_exclusion_falls_back_as_jax():
    """A lane armed on a solve with excluded partitions: a load spike
    re-solves (equal to the JAX lane), a partition add falls back with
    FALLBACK_OPTIONS (incremental.py:650-653), as the JAX lane does."""
    settings = dict(BASE, bucket_partitions=True, bucket_brokers=True)
    okw = dict(excluded_partitions=np.random.default_rng(11).random(190) < 0.1)
    jm, tm = jgen.random_cluster(7, PROP), from_numpy(_arrays())
    jo = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**settings))
    to = topt.GoalOptimizer(settings=topt.OptimizerSettings(**settings), device="cpu")
    jopts, topts = jctx.OptimizationOptions(**okw), tctx.OptimizationOptions(**okw)
    jo.optimizations(jm, GOALS, jopts, raise_on_hard_failure=False)
    to.optimizations(tm, GOALS, topts, raise_on_hard_failure=False)
    f = _arrays()
    spike = dict(f, part_load=np.where((f["topic_id"] == 3)[:, None],
                                       f["part_load"] * np.float32(4.0), f["part_load"]))
    added = dict(f, assignment=np.concatenate([f["assignment"], [[0, 1]]]).astype(np.int32),
                 part_load=np.concatenate([f["part_load"], np.full((1, 6), 0.03, np.float32)]),
                 topic_id=np.concatenate([f["topic_id"], [4]]).astype(np.int32))
    for new, gen in ((spike, 2), (added, 3)):
        jl, tl = jinc.IncrementalLane(jo), tinc.IncrementalLane(to)
        assert jl.arm(jm, jopts, GOALS, generation=1) and tl.arm(tm, topts, GOALS, generation=1)
        jout = jl.propose(jm._replace(**new), generation=gen)
        tout = tl.propose(from_numpy(new), generation=gen)
        assert tout.ok == jout.ok and tout.fallback_reason == jout.fallback_reason
        if new is added:
            assert tout.fallback_reason == tinc.FALLBACK_OPTIONS
        else:
            goals = list(tout.affected)
            assert tout.result.provenance.digest(goals=goals) == \
                jout.result.provenance.digest(goals=goals)
            keep = okw["excluded_partitions"]
            assert np.array_equal(tout.result.final_assignment[:190][keep],
                                  f["assignment"][keep])


def test_k10_carries_the_options_of_the_armed_context():
    """K10's plain version on a context prepared under options: the
    immigrant flag, the relaxed thresholds and the partition mask ride
    along; a broker death recomputes the broker masks from the lane's base
    masks, so an excluded broker stays out."""
    from cruise_control_torch.kernels.delta_scatter import delta_scatter_plain

    grp = _group(20)
    settings = dict(BASE, bucket_partitions=True, bucket_brokers=True)
    tc = dataclasses.replace(TConstraint.default(),
                             goal_violation_distribution_threshold_multiplier=MULTIPLIER)
    okw = dict(only_move_immigrants=True, is_triggered_by_goal_violation=True,
               excluded_brokers_for_replica_move=_mask(grp[:10]),
               excluded_partitions=np.random.default_rng(11).random(190) < 0.1)
    f = _arrays()
    to = topt.GoalOptimizer(constraint=tc, settings=topt.OptimizerSettings(**settings),
                            device="cpu")
    tm, topts = from_numpy(f), tctx.OptimizationOptions(**okw)
    to.optimizations(tm, GOALS, topts, raise_on_hard_failure=False)
    lane = tinc.IncrementalLane(to)
    assert lane.arm(tm, topts, GOALS, generation=1)
    static = lane._armed.static
    st = f["broker_state"].copy()
    st[int(grp[15])] = 3
    deltas, reason = tinc.derive_deltas(tm, from_numpy(dict(f, broker_state=st)))
    assert reason is None and len(deltas) == 1
    out = delta_scatter_plain(static, tinc.build_delta_batch(deltas, 64, 6),
                              lane._armed.base_replica_dst, lane._armed.base_leadership_dst)
    assert bool(out.only_move_immigrants)
    for field in ("replica_balance_pct", "resource_balance_pct", "movable_partition"):
        assert torch.equal(getattr(out, field), getattr(static, field)), field
    assert not out.replica_dst_ok[torch.from_numpy(grp[:10]).long()].any()
    assert not out.replica_dst_ok[int(grp[15])] and static.replica_dst_ok[int(grp[15])]
