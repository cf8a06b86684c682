"""The partition-axis mesh: the port's parallel/ against the JAX package's
on the CPU, the JAX side on the conftest's 8 virtual CPU devices, the port's
mesh eight shards of the CPU (`make_mesh(8, devices=["cpu"] * 8)`).

The model, settings and goals are tests/test_spmd.py's: `batch_k=1` sends
the move goals through the greedy grid, whose shortlist then runs shard by
shard (K9 a shard, K12's merge), and the swap goal through the drain engine
on the mesh's first device.

- The port's mesh-8 greedy run equals the JAX package's mesh-8 run and the
  port's mesh-1 run: decision digest, final assignment, violated sets.
- Padding to a mesh multiple leaves every decision as it was.
- `make_grid_shortlist` equals JAX's tuple for tuple (D 2 and 8, two
  goals, k_sel 1 and 4).
- The plain merge equals `jnp.lexsort((g_p, -g_score))` on ties across
  shards, -0.0 against +0.0, all -inf shards and NaN.
- The partition stats equal JAX's `make_partition_stats` and the host's
  numpy counts.
- `make_mesh_from_config` follows JAX's semantics, its axis name included.
- A lane proposal under a mesh equals a scratch solve on the mesh and the
  lane without one.
- `collective_totals()` counts the mesh's gathers and sums.

The slow lane adds the goal-family matrix (tests/test_spmd.py:141-177) and
the batched 5-goal equivalence (tests/test_sharding.py:56-97). No assertion
reads a clock.
"""

import dataclasses

import jax
import jax.numpy as jnp
import merge_cases
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import acceptance as jacc
from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.context import build_static_ctx as jbuild_static
from cruise_control_tpu.analyzer.context import dims_of as jdims_of
from cruise_control_tpu.analyzer.goals import goals_by_priority as jgoals
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.config.cruise_config import CruiseControlConfig as JConfig
from cruise_control_tpu.models import generators as jgen
from cruise_control_tpu.parallel import sharding as jsharding
from cruise_control_tpu.parallel import spmd as jspmd
from cruise_control_torch.analyzer import acceptance as tacc
from cruise_control_torch.analyzer import incremental as tinc
from cruise_control_torch.analyzer import optimizer as topt
from cruise_control_torch.analyzer.context import OptimizationOptions
from cruise_control_torch.analyzer.context import build_static_ctx as tbuild_static
from cruise_control_torch.analyzer.context import compute_aggregates, dims_of
from cruise_control_torch.analyzer.goals import goals_by_priority as tgoals
from cruise_control_torch.common.telemetry import TELEMETRY
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.config.cruise_config import CruiseControlConfig as TConfig
from cruise_control_torch.kernels.shard_merge import shard_merge, shard_merge_plain
from cruise_control_torch.models.flat_model import from_numpy, sanity_check
from cruise_control_torch.parallel import sharding as tsharding
from cruise_control_torch.parallel import spmd as tspmd


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Heavy CPU module: one intra-op thread (six worker processes share the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: tests/test_spmd.py's settings, goals and model
GRID = dict(batch_k=1, max_rounds_per_goal=6, num_dst_candidates=8)
GRID_GOALS = ["RackAwareGoal", "DiskUsageDistributionGoal", "LeaderReplicaDistributionGoal"]
PROP = jgen.ClusterProperty(num_racks=4, num_brokers=12, num_topics=16,
                            mean_partitions_per_topic=7.0, replication_factor=2,
                            load_distribution="exponential", mean_utilization=0.4)
CPU8 = [torch.device("cpu")] * 8


def _arrays(model):
    return {k: np.asarray(v) for k, v in model._asdict().items()}


@pytest.fixture(scope="module")
def jmodel():
    return jgen.random_cluster(seed=11, prop=PROP)


@pytest.fixture(scope="module")
def tmesh():
    return tsharding.make_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def runs(jmodel, tmesh):
    """JAX's mesh-8 run, the port's mesh-1 and mesh-8 runs, and the
    collective totals the port's mesh-8 run added."""
    assert len(jax.devices()) >= 8, "conftest must pin 8 virtual CPU devices"
    jres = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**GRID),
                              mesh=jsharding.make_mesh(8)).optimizations(
        jmodel, GRID_GOALS, raise_on_hard_failure=False)
    tm = from_numpy(_arrays(jmodel))
    settings = topt.OptimizerSettings(**GRID)
    base = topt.GoalOptimizer(settings=settings, device="cpu").optimizations(
        tm, GRID_GOALS, raise_on_hard_failure=False)
    before = TELEMETRY.collective_totals()
    sharded = topt.GoalOptimizer(settings=settings, mesh=tmesh).optimizations(
        tm, GRID_GOALS, raise_on_hard_failure=False)
    after = TELEMETRY.collective_totals()
    return dict(jax=jres, base=base, sharded=sharded, tm=tm, before=before, after=after)


def _same_decisions(a, b):
    np.testing.assert_array_equal(np.asarray(a.final_assignment), np.asarray(b.final_assignment))
    assert a.violated_goals_after == b.violated_goals_after
    assert a.violated_goals_before == b.violated_goals_before
    da, db = a.provenance.digest(), b.provenance.digest()
    assert (da["checksum"], da["moves"], da["byGoal"]) == (db["checksum"], db["moves"],
                                                           db["byGoal"])


def test_mesh8_equals_jax_mesh8_and_the_port_mesh1(runs):
    _same_decisions(runs["sharded"], runs["jax"])
    _same_decisions(runs["sharded"], runs["base"])
    assert runs["sharded"].provenance.digest()["moves"] > 0
    assert runs["sharded"].final_assignment.shape[0] == runs["tm"].num_partitions
    sanity_check(runs["tm"]._replace(assignment=torch.from_numpy(
        runs["sharded"].final_assignment)))


def test_padding_invariance_at_mesh_divisible_sizes(runs, tmesh):
    """The model padded to a mesh multiple first makes the same decisions:
    pad rows are unassigned and immovable, dead candidates on their shard."""
    tm = runs["tm"]
    padded = tsharding.pad_partitions(tm, tmesh.size)
    assert padded.num_partitions % tmesh.size == 0
    assert padded.num_partitions > tm.num_partitions
    pre = topt.GoalOptimizer(settings=topt.OptimizerSettings(**GRID), mesh=tmesh).optimizations(
        padded, GRID_GOALS, raise_on_hard_failure=False)
    p = tm.num_partitions
    np.testing.assert_array_equal(pre.final_assignment[:p], runs["sharded"].final_assignment)
    assert pre.provenance.digest()["checksum"] == runs["sharded"].provenance.digest()["checksum"]
    assert np.all(pre.final_assignment[p:] < 0)


def _contexts(jmodel, n_dev):
    """Both packages' static context and aggregates of the model padded to a
    multiple of `n_dev`, and its dims."""
    jpadded = jsharding.pad_partitions(jmodel, n_dev)
    dims = jdims_of(jpadded)
    jst = jbuild_static(jpadded, JConstraint.default(), dims)
    jagg = jopt._jit_compute_aggregates(jst, jnp.asarray(jpadded.assignment), dims)
    tpadded = from_numpy(_arrays(jpadded))
    tdims = dims_of(tpadded)
    tst = tbuild_static(tpadded, TConstraint.default(), tdims)
    tagg = compute_aggregates(tst, tpadded.assignment, tdims)
    return jpadded, dims, jst, jagg, tdims, tst, tagg


@pytest.mark.parametrize("n_dev,goal_name,batch_k", [
    (2, "RackAwareGoal", 1), (8, "RackAwareGoal", 1),
    (2, "LeaderReplicaDistributionGoal", 1), (8, "LeaderReplicaDistributionGoal", 1),
    (8, "LeaderReplicaDistributionGoal", 4)])
def test_grid_shortlist_equals_jax(jmodel, n_dev, goal_name, batch_k):
    """One round's sharded shortlist, tuple for tuple: the JAX shard_map
    kernel on `n_dev` virtual devices against the port's on `n_dev` shards of
    the CPU (and its plain path)."""
    _, dims, jst, jagg, tdims, tst, tagg = _contexts(jmodel, n_dev)
    [jgoal] = jgoals([goal_name])
    [tgoal] = tgoals([goal_name])
    settings = dict(GRID, batch_k=batch_k)
    jshortlist = jspmd.make_grid_shortlist(jsharding.make_mesh(n_dev), jgoal, dims,
                                           jopt.OptimizerSettings(**settings))

    def jround(st, agg):
        # the round's inputs as the jitted optimizer computes them
        gs = jgoal.prepare(st, agg, dims)
        tables = jacc.empty_tables(dims)
        cands = jopt._dst_candidates(st, gs, agg, jgoal, dims, 8, tables)
        return cands, jshortlist(st, agg, gs, tables, cands)

    jcands, want = jax.jit(jround)(jst, jagg)
    tmesh = tsharding.make_mesh(n_dev, devices=CPU8)
    tgs = tgoal.prepare(tst, tagg, tdims)
    ttables = tacc.empty_tables(tdims, "cpu")
    tcands = topt.dst_candidates(tst, tgs, tagg, tgoal, tdims, 8, ttables)
    assert np.array_equal(tcands.numpy(), np.asarray(jcands))
    shortlist = tspmd.make_grid_shortlist(tmesh, tgoal, tdims, topt.OptimizerSettings(**settings))
    placed = tsharding.place_static(tst, tmesh)
    for got in (shortlist(placed, tagg, tgs, ttables, tcands),
                shortlist.plain(placed, tagg, tgs, ttables, tcands)):
        assert len(got) == len(want) == 5
        for w, g in zip(want, got):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype and g.shape == w.shape
            assert g.numpy().tobytes() == w.tobytes(), (goal_name, w, g)
    # the unsharded K9 shortlist agrees wherever k_sel = 1
    if batch_k == 1:
        from cruise_control_torch.kernels.grid_shortlist import grid_shortlist

        ref = grid_shortlist(tst, tagg, ttables, tgoal, tgs, tcands, 1)
        for r, g in zip(ref, shortlist(placed, tagg, tgs, ttables, tcands)):
            assert r.numpy().tobytes() == g.numpy().tobytes()


#: the JAX merge's order (parallel/spmd.py:185)
_jax_merge_order = jax.jit(lambda g_score, g_p: jnp.lexsort((g_p, -g_score)))


@pytest.mark.parametrize("case", merge_cases.KINDS)
@pytest.mark.parametrize("n_dev,k_loc", merge_cases.SHAPES[:6])
def test_plain_merge_equals_lexsort(case, n_dev, k_loc):
    """K12's plain version against the JAX merge, `jnp.lexsort((g_p,
    -g_score))[:k_sel]`, on the same records (tests/merge_cases.py)."""
    rng = np.random.default_rng([merge_cases.KINDS.index(case), n_dev, k_loc])
    s, rec = merge_cases.records(case, n_dev, k_loc, rng)
    order = np.asarray(_jax_merge_order(s, rec[:, 0]))
    for k_sel in sorted({1, k_loc, n_dev * k_loc}):
        sel = order[:k_sel]
        for fn in (shard_merge_plain, shard_merge):
            got_s, got_rec = fn(torch.from_numpy(s), torch.from_numpy(rec), k_sel)
            assert got_s.numpy().tobytes() == s[sel].tobytes(), (case, k_sel)
            assert np.array_equal(got_rec.numpy(), rec[sel].T), (case, k_sel)
    if case == "all -inf":
        assert int(shard_merge_plain(torch.from_numpy(s), torch.from_numpy(rec), 1)[1][0, 0]) \
            == int(rec[:, 0].min())


def test_partition_stats_equal_jax_and_host(jmodel, tmesh):
    """The coverage certificate: the mesh's integer sums equal JAX's and the
    host's exact counts, on the model padded to 8 shards with a few
    partitions immovable (every shard owns its rows once)."""
    jpadded, dims, jst, jagg, tdims, tst, tagg = _contexts(jmodel, tmesh.size)
    movable = np.asarray(jst.movable_partition).copy()
    movable[::5] = False
    jst = jst._replace(movable_partition=jnp.asarray(movable))
    tst = tst._replace(movable_partition=torch.from_numpy(movable))
    want = [int(x) for x in jax.jit(jspmd.make_partition_stats(jsharding.make_mesh(8)))(
        jst, jagg)]
    host = [int(movable.sum()), int((np.asarray(jpadded.assignment) >= 0).sum()),
            jpadded.num_partitions]
    stats = tspmd.make_partition_stats(tmesh)
    placed = tsharding.place_static(tst, tmesh)
    for got in (stats(placed, tagg), stats.plain(placed, tagg), stats(tst, tagg)):
        assert all(t.dtype == torch.int32 and t.dim() == 0 for t in got)
        assert [int(t) for t in got] == want == host


def test_make_mesh_from_config_follows_jax(monkeypatch):
    """`tpu.mesh.devices` 0, 1 and N against the JAX package's on its eight
    virtual devices, the port seeing eight shards of the CPU as its cards;
    `tpu.mesh.axis.name` flows through to the mesh."""
    monkeypatch.setattr(tsharding, "visible_devices", lambda: tuple(CPU8))
    for n in (0, 1, 2, 8):
        props = {"tpu.mesh.devices": str(n), "tpu.mesh.axis.name": "shards"}
        jm = jsharding.make_mesh_from_config(JConfig(props))
        tm = tsharding.make_mesh_from_config(TConfig(props))
        assert (jm is None) == (tm is None), n
        if tm is not None:
            assert tm.size == jm.size and tm.axis_names == tuple(jm.axis_names) == ("shards",)
    for n in (9, 16):
        props = {"tpu.mesh.devices": str(n)}
        with pytest.raises(ValueError) as jerr:
            jsharding.make_mesh_from_config(JConfig(props))
        with pytest.raises(ValueError) as terr:
            tsharding.make_mesh_from_config(TConfig(props))
        assert str(terr.value) == str(jerr.value) == f"need {n} devices, have 8"
    monkeypatch.setattr(tsharding, "visible_devices", lambda: (torch.device("cpu"),))
    assert tsharding.make_mesh_from_config(TConfig({"tpu.mesh.devices": "0"})) is None


def test_optimizer_device_must_be_the_mesh_first_device(tmesh):
    assert topt.GoalOptimizer(mesh=tmesh)._device == torch.device("cpu")
    assert topt.GoalOptimizer(mesh=tmesh, device="cpu")._device == torch.device("cpu")
    with pytest.raises(ValueError, match="first device"):
        topt.GoalOptimizer(mesh=tmesh, device="meta")


@pytest.fixture(scope="module")
def lanes(jmodel, tmesh):
    """A lane on a mesh-8 optimizer and one without a mesh, each armed on
    its full bucketed greedy solve (96 partitions: the mesh pads nothing
    more), both proposing a load spike on topic 3; and a scratch solve of the
    affected goals on another mesh-8 optimizer."""
    settings = topt.OptimizerSettings(**GRID, bucket_partitions=True)
    arrays = _arrays(jmodel)
    spike = dict(arrays, part_load=arrays["part_load"].copy())
    spike["part_load"][arrays["topic_id"] == 3] *= np.float32(4.0)
    out = {}
    for label, kw in (("mesh", dict(mesh=tmesh)), ("one device", dict(device="cpu"))):
        o = topt.GoalOptimizer(settings=settings, **kw)
        tm = from_numpy(arrays)
        full = o.optimizations(tm, GRID_GOALS, raise_on_hard_failure=False)
        lane = tinc.IncrementalLane(o)
        assert lane.arm(tm, OptimizationOptions(), [g.name for g in full.goal_results],
                        generation=1)
        out[label] = (full, lane.propose(from_numpy(spike), generation=2), lane)
    affected = list(out["mesh"][1].affected)
    out["scratch"] = topt.GoalOptimizer(settings=settings, mesh=tmesh).optimizations(
        from_numpy(spike), affected, raise_on_hard_failure=False)
    return out


def test_lane_proposal_under_a_mesh(lanes, tmesh):
    full, out, lane = lanes["mesh"]
    assert out.ok, out.fallback_reason
    assert full.bucketed["padded"]["num_partitions"] == 96
    goals = list(out.affected)
    assert goals and out.result.provenance.digest(goals=goals)["moves"] > 0
    for other in (lanes["scratch"], lanes["one device"][1].result):
        assert out.result.provenance.digest(goals=goals) == other.provenance.digest(goals=goals)
        np.testing.assert_array_equal(out.result.final_assignment, other.final_assignment)
    # K10 scattered into the canonical context; the lane holds it placed
    static = lane._armed.static
    assert isinstance(static, tsharding.PlacedStatic) and static.mesh == tmesh
    assert len(static.shards) == 8 and static.shards[3].part_load.shape[0] == 12
    assert static.part_load is lane._armed.static_canon.part_load
    assert not isinstance(lanes["one device"][2]._armed.static, tsharding.PlacedStatic)


def test_collective_totals_after_a_mesh_run(runs, tmesh, jmodel):
    """The mesh-8 run's gathers, one a grid round, each 8 records of 20
    bytes, counted as `all-gather`s made in rounds; the partition stats'
    sum as an `all-reduce` outside them; snapshot() carries the same block."""
    before, after = runs["before"], runs["after"]
    gathers = after["byOp"]["all-gather"]["count"] - before["byOp"].get(
        "all-gather", {"count": 0})["count"]
    assert gathers > 0
    assert after["byOp"]["all-gather"]["bytes"] - before["byOp"].get(
        "all-gather", {"bytes": 0})["bytes"] == gathers * 8 * 20
    assert after["perRoundOps"] - before["perRoundOps"] == gathers
    _, _, _, _, tdims, tst, tagg = _contexts(jmodel, tmesh.size)
    mid = TELEMETRY.collective_totals()
    tspmd.make_partition_stats(tmesh)(tst, tagg)
    now = TELEMETRY.collective_totals()
    assert now["byOp"]["all-reduce"]["count"] == mid["byOp"].get(
        "all-reduce", {"count": 0})["count"] + 1
    assert now["byOp"]["all-reduce"]["bytes"] == mid["byOp"].get(
        "all-reduce", {"bytes": 0})["bytes"] + 8 * 3 * 4
    assert now["perRoundOps"] == mid["perRoundOps"] and now["ops"] == mid["ops"] + 1
    assert TELEMETRY.snapshot()["collectives"] == now
    rows = [r for r in TELEMETRY.programs() if r["program"] == tspmd.GRID_SHORTLIST_ENTRY]
    assert rows and all(r["costAvailable"] is False for r in rows)


#: tests/test_spmd.py's goal families
GOAL_FAMILIES = {
    "capacity": ["ReplicaCapacityGoal", "DiskCapacityGoal", "NetworkInboundCapacityGoal",
                 "CpuCapacityGoal"],
    "distribution": ["ReplicaDistributionGoal", "TopicReplicaDistributionGoal",
                     "PotentialNwOutGoal"],
    "leadership": ["NetworkOutboundCapacityGoal", "LeaderReplicaDistributionGoal",
                   "LeaderBytesInDistributionGoal"],
    "usage-swap": ["DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal",
                   "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal"],
}


@pytest.mark.slow
@pytest.mark.parametrize("family", sorted(GOAL_FAMILIES))
def test_goal_family_decision_identity(jmodel, tmesh, family):
    """Every goal family: the port's mesh-8 run equals its mesh-1 run and
    the JAX package's mesh-1 run, and the JAX package's mesh-8 run wherever
    that equals JAX's mesh-1 run. JAX's GSPMD-partitioned drain and swap
    rounds give the usage-swap family another decision digest on a mesh
    (the same final assignment and move counts; ROADMAP.md Queue 3, F6);
    the port runs those rounds whole on the mesh's first device."""
    goals = GOAL_FAMILIES[family]
    tm = from_numpy(_arrays(jmodel))
    settings = topt.OptimizerSettings(**GRID)
    base = topt.GoalOptimizer(settings=settings, device="cpu").optimizations(
        tm, goals, raise_on_hard_failure=False)
    sharded = topt.GoalOptimizer(settings=settings, mesh=tmesh).optimizations(
        tm, goals, raise_on_hard_failure=False)
    jbase = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**GRID)).optimizations(
        jmodel, goals, raise_on_hard_failure=False)
    jres = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**GRID),
                              mesh=jsharding.make_mesh(8)).optimizations(
        jmodel, goals, raise_on_hard_failure=False)
    _same_decisions(sharded, base)
    _same_decisions(sharded, jbase)
    np.testing.assert_array_equal(sharded.final_assignment, np.asarray(jres.final_assignment))
    if jres.provenance.digest()["checksum"] == jbase.provenance.digest()["checksum"]:
        _same_decisions(sharded, jres)
    else:
        assert family == "usage-swap"


#: tests/test_sharding.py's batched settings and goals
BATCHED = dict(batch_k=16, max_rounds_per_goal=16, num_dst_candidates=8, num_swap_pairs=8,
               swap_candidates=8)
BATCHED_GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "ReplicaDistributionGoal",
                 "DiskUsageDistributionGoal", "LeaderReplicaDistributionGoal"]


@pytest.mark.slow
def test_batched_five_goal_equivalence(jmodel, tmesh):
    """The drain engine's 5-goal stack on the mesh (no grid round: every
    round runs whole on the first device) equals the port's run without a
    mesh and the JAX package's mesh-8 run, goal rows included."""
    tm = from_numpy(_arrays(jmodel))
    settings = topt.OptimizerSettings(**BATCHED)
    base = topt.GoalOptimizer(settings=settings, device="cpu").optimizations(
        tm, BATCHED_GOALS, raise_on_hard_failure=False)
    sharded = topt.GoalOptimizer(settings=settings, mesh=tmesh).optimizations(
        tm, BATCHED_GOALS, raise_on_hard_failure=False)
    jres = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**BATCHED),
                              mesh=jsharding.make_mesh(8)).optimizations(
        jmodel, BATCHED_GOALS, raise_on_hard_failure=False)
    for other in (base, jres):
        _same_decisions(sharded, other)
        for a, b in zip(sharded.goal_results, other.goal_results):
            assert (a.violated_brokers_after, a.rounds, a.converged, a.cost_after) == (
                b.violated_brokers_after, b.rounds, b.converged, b.cost_after), a.name
    sanity_check(tm._replace(assignment=torch.from_numpy(sharded.final_assignment)))
