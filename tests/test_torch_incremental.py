"""The incremental re-proposal lane (cruise_control_torch/analyzer/
incremental.py) against the JAX package's, on the same numpy inputs (CPU).

The delta vocabulary, the sensitivity map, the batch packing and every
fallback reason are compared with the JAX functions directly. The lane runs
on tests/test_bucketing.py's model (70 brokers padded to 80, 190 partitions
padded to 192) under the service's settings with bucketing: both packages
solve it once, arm a lane on that solve, and propose a load spike, a broker
death and a partition add, each inside the bucket, so the JAX package
compiles one machine program for the module. Each lane proposal must equal
JAX's (decision digest, final assignment, bucket record) and the port's own
scratch solve of the same goal subset on the perturbed model, with no move
on the goals the sensitivity map leaves out; K10's plain version must give
the context a build from scratch gives. Integers and digests exactly, floats
bit for bit. No assertion reads a clock.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import incremental as jinc
from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.models import generators as jgen
from cruise_control_tpu.models.flat_model import FlatClusterModel as JModel
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.analyzer import incremental as tinc
from cruise_control_torch.analyzer import optimizer as topt
from cruise_control_torch.analyzer.goals import goals_by_priority
from cruise_control_torch.kernels.delta_scatter import delta_scatter_plain
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


PROP = jgen.ClusterProperty(num_racks=7, num_brokers=70, num_topics=20,
                            mean_partitions_per_topic=10.0, replication_factor=2,
                            num_dead_brokers=1)
#: the JAX side of SERVICE_SETTINGS (the batch_k=1 grid's width, which
#: batch_k = 16 never reads, aside)
JAX_SERVICE = dict(batch_k=16, max_rounds_per_goal=64, drain_src=512, drain_per_broker=8,
                   drain_dst=64, apply_waves=8, bulk_waves=16, bulk_min_brokers=32,
                   num_swap_pairs=8, swap_candidates=8, swaps_per_broker=4, polish_rounds=0,
                   chunk_rounds=32, bucket_partitions=True, bucket_brokers=True, ledger=True,
                   num_dst_candidates=8)


def _arrays():
    return {k: np.asarray(v).copy() for k, v in jgen.random_cluster(7, PROP)._asdict().items()}


def _small():
    """tests/test_incremental.py's small model (6 brokers, 2 racks)."""
    m = jgen.random_cluster(11, jgen.ClusterProperty(
        num_racks=2, num_brokers=6, num_topics=5, mean_partitions_per_topic=4.0,
        replication_factor=2))
    return {k: np.asarray(v).copy() for k, v in m._asdict().items()}


def _bits_equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
    return a.shape == b.shape and np.array_equal(a, b)


# -- perturbations, as numpy field dicts (one recipe for both packages) ---------


def _spike(f):
    pl = f["part_load"].copy()
    pl[f["topic_id"] == 3] *= np.float32(4.0)
    return dict(f, part_load=pl)


def _death(f, broker=5):
    st = f["broker_state"].copy()
    st[broker] = 3
    return dict(f, broker_state=st)


def _add(f, rows=((0, 1), (2, 3)), topic=4):
    a = f["assignment"]
    n = len(rows)
    return dict(f, assignment=np.concatenate([a, np.array(rows, a.dtype)]),
                part_load=np.concatenate([f["part_load"],
                                          np.full((n, f["part_load"].shape[1]), 0.03,
                                                  np.float32)]),
                topic_id=np.concatenate([f["topic_id"], np.full(n, topic, np.int32)]))


def _states(f):
    """DEAD -> NEW (revival), ALIVE -> DEAD (death), ALIVE -> DEMOTED (state)."""
    old = f["broker_state"].copy()
    old[0] = 3
    new = old.copy()
    new[0], new[1], new[2] = 1, 3, 2
    return dict(f, broker_state=old), dict(f, broker_state=new)


def _drop_broker(f):
    return dict(f, **{k: f[k][:-1] for k in ("broker_capacity", "broker_rack", "broker_host",
                                              "broker_state")})


def _wider(f):
    a = f["assignment"]
    return dict(f, assignment=np.concatenate([a, np.full((a.shape[0], 1), -1, a.dtype)], axis=1))


def _cap_edit(f):
    cap = f["broker_capacity"].copy()
    cap[0, 0] *= 2
    return dict(f, broker_capacity=cap)


def _rack_edit(f):
    rack = f["broker_rack"].copy()
    rack[1] = (rack[1] + 1) % 2
    return dict(f, broker_rack=rack)


def _topic_delete(f):
    k = f["topic_id"].shape[0] - 3
    return dict(f, assignment=f["assignment"][:k], part_load=f["part_load"][:k],
                topic_id=f["topic_id"][:k])


def _row_shift(f):
    return dict(f, topic_id=np.roll(f["topic_id"], 1))


def _load_rows(f):
    pl = f["part_load"].copy()
    pl[2] *= np.float32(4.0)
    pl[5] *= np.float32(0.5)
    return dict(f, part_load=pl)


DERIVE_CASES = {
    "identical": lambda f: (f, f),
    "rf-growth": lambda f: (f, _wider(f)),
    "broker-count": lambda f: (f, _drop_broker(f)),
    "capacity-edit": lambda f: (f, _cap_edit(f)),
    "rack-edit": lambda f: (f, _rack_edit(f)),
    "topic-delete": lambda f: (f, _topic_delete(f)),
    "row-shift": lambda f: (f, _row_shift(f)),
    "state-transitions": _states,
    "load-spike": lambda f: (f, _load_rows(f)),
    "partition-add": lambda f: (f, _add(f)),
    "mixed": lambda f: (f, _add(_death(_load_rows(f), 4))),
}


def _delta_key(d):
    return (d.kind, d.broker, d.state, d.row, d.topic,
            None if d.load is None else np.asarray(d.load, np.float32).tobytes())


@pytest.mark.parametrize("case", list(DERIVE_CASES))
def test_derive_deltas_equals_jax(case):
    old, new = DERIVE_CASES[case](_small())
    jd, jr = jinc.derive_deltas(JModel(**old), JModel(**new))
    td, tr = tinc.derive_deltas(from_numpy(old), from_numpy(new))
    assert tr == jr
    assert [_delta_key(d) for d in td] == [_delta_key(d) for d in jd]


def test_sensitivity_map_equals_jax():
    assert set(tinc.SENSITIVITY) == set(jinc.SENSITIVITY)
    for kind, goals in tinc.SENSITIVITY.items():
        assert goals == jinc.SENSITIVITY[kind] or set(goals) == set(jinc.SENSITIVITY[kind]), kind
    assert tinc._LOAD_GOALS == jinc._LOAD_GOALS and tinc._COUNT_GOALS == jinc._COUNT_GOALS


AFFECTED_CASES = [
    (tinc.DELTA_LOAD_SPIKE,), (tinc.DELTA_PART_ADD,), (tinc.DELTA_BROKER_DEATH,),
    (tinc.DELTA_BROKER_REVIVAL,), (tinc.DELTA_BROKER_STATE,), (tinc.DELTA_TOPIC_DELETE,),
    (tinc.DELTA_LOAD_SPIKE, tinc.DELTA_PART_ADD), (tinc.DELTA_LOAD_SPIKE, tinc.DELTA_TOPIC_DELETE),
    (tinc.DELTA_BROKER_REVIVAL, tinc.DELTA_PART_ADD),
]


@pytest.mark.parametrize("kinds", AFFECTED_CASES, ids=["+".join(k) for k in AFFECTED_CASES])
@pytest.mark.parametrize("armed", ["all", "hard", "two"])
def test_affected_goals_equal_jax(kinds, armed):
    names = {"all": [g.name for g in goals_by_priority(None)],
             "hard": [g.name for g in goals_by_priority(None) if g.is_hard],
             "two": ["TopicReplicaDistributionGoal", "DiskCapacityGoal"]}[armed]
    td = [tinc.ModelDelta(kind=k, row=0, broker=0, state=1, topic=0) for k in kinds]
    jd = [jinc.ModelDelta(kind=k, row=0, broker=0, state=1, topic=0) for k in kinds]
    assert tinc.affected_goals(td, names) == jinc.affected_goals(jd, names)


def test_build_delta_batch_equals_jax():
    specs = [dict(kind=tinc.DELTA_BROKER_DEATH, broker=3, state=3),
             dict(kind=tinc.DELTA_LOAD_SPIKE, row=7, load=np.full(6, 2.5, np.float32)),
             dict(kind=tinc.DELTA_PART_ADD, row=9, topic=2, load=np.arange(6, dtype=np.float32)),
             dict(kind=tinc.DELTA_BROKER_STATE, broker=1, state=2)]
    tb = tinc.build_delta_batch([tinc.ModelDelta(**s) for s in specs], 8, 6)
    jb = jinc.build_delta_batch([jinc.ModelDelta(**s) for s in specs], 8, 6)
    for f in tb._fields:
        assert _bits_equal(getattr(jb, f), getattr(tb, f)), f
    assert (tb.kind[4:] == tinc.KIND_NOOP).all()


def test_unknown_delta_kind_is_refused():
    with pytest.raises(ValueError):
        tinc.ModelDelta(kind="capacity_edit")


# -- K10 on the bucketed context ---------------------------------------------------


@pytest.fixture(scope="module")
def contexts():
    """The padded model and static context of both packages (the prep cache's
    miss path), with the lane's base masks."""
    jo = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**JAX_SERVICE))
    _, jpm, jdims, js, _, _ = jo._build_ctx(jgen.random_cluster(7, PROP),
                                            jopt.OptimizationOptions())
    to = topt.GoalOptimizer(settings=topt.SERVICE_SETTINGS, device="cpu")
    _, tpm, tdims, ts, _, _ = to._build_ctx(from_numpy(_arrays()))
    valid = np.arange(tdims.num_brokers) < 70
    return dict(jpm=jpm, js=js, jdims=jdims, tpm=tpm, ts=ts, tdims=tdims, valid=valid, to=to)


def _lane_batch(f_old, f_new, max_deltas=64):
    deltas, reason = tinc.derive_deltas(from_numpy(f_old), from_numpy(f_new))
    assert reason is None
    return deltas, tinc.build_delta_batch(deltas, max_deltas, 6)


@pytest.mark.parametrize("case", ["spike", "death", "add", "mixed"])
def test_delta_scatter_plain_equals_jax_on_the_bucketed_context(contexts, case):
    f = _arrays()
    new = {"spike": _spike, "death": _death, "add": _add,
           "mixed": lambda x: _add(_death(_spike(x), 9))}[case](f)
    _, tb = _lane_batch(f, new)
    jb = jinc.DeltaBatch(**{k: jnp.asarray(getattr(tb, k).numpy()) for k in tb._fields})
    valid = contexts["valid"]
    jout = jax.jit(jinc.apply_delta_batch)(contexts["js"], jb, jnp.asarray(valid),
                                            jnp.asarray(valid))
    tv = torch.from_numpy(valid)
    tout = delta_scatter_plain(contexts["ts"], tb, tv, tv)
    for field in tout._fields:
        assert _bits_equal(jout._asdict()[field], getattr(tout, field)), field


@pytest.mark.parametrize("case", ["spike", "death", "add", "mixed"])
def test_delta_scatter_equals_a_build_from_scratch(contexts, case):
    """The scattered context equals build_static_ctx on the perturbed padded
    model (the lane's host twin), field for field."""
    f = _arrays()
    new = {"spike": _spike, "death": _death, "add": _add,
           "mixed": lambda x: _add(_death(_spike(x), 9))}[case](f)
    deltas, tb = _lane_batch(f, new)
    tv = torch.from_numpy(contexts["valid"])
    tout = delta_scatter_plain(contexts["ts"], tb, tv, tv)
    to = contexts["to"]
    _, scratch_pm, dims, scratch, _, _ = to._build_ctx(from_numpy(new))
    assert dims == contexts["tdims"]
    p_new = new["topic_id"].shape[0]
    for field in tout._fields:
        want = getattr(scratch, field)
        if field == "num_valid_partitions":
            assert float(want) == float(tout.num_valid_partitions) == p_new
        assert _bits_equal(want, getattr(tout, field)), field


# -- the lane ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def solved():
    """Both packages' full service solve of the model (bucketed), armed on."""
    jm = jgen.random_cluster(7, PROP)
    jo = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**JAX_SERVICE))
    jopts = jopt.OptimizationOptions()
    jfull = jo.optimizations(jm, None, options=jopts, raise_on_hard_failure=False)
    to = topt.GoalOptimizer(settings=topt.SERVICE_SETTINGS, device="cpu")
    tm, topts = from_numpy(_arrays()), tctx.OptimizationOptions()
    tfull = to.optimizations(tm, None, options=topts, raise_on_hard_failure=False)
    names = tuple(g.name for g in tfull.goal_results)
    return dict(jm=jm, jo=jo, jopts=jopts, jfull=jfull, to=to, tm=tm, topts=topts,
                tfull=tfull, names=names)


def _lanes(solved, config=tinc.IncrementalConfig()):
    jl = jinc.IncrementalLane(solved["jo"], jinc.IncrementalConfig(**dataclasses.asdict(config)))
    tl = tinc.IncrementalLane(solved["to"], config)
    assert jl.arm(solved["jm"], solved["jopts"], solved["names"], generation=1)
    assert tl.arm(solved["tm"], solved["topts"], solved["names"], generation=1)
    return jl, tl


def test_full_solves_equal(solved):
    names = list(solved["names"])
    assert solved["tfull"].provenance.digest(goals=names) == \
        solved["jfull"].provenance.digest(goals=names)
    assert solved["tfull"].bucketed == solved["jfull"].bucketed
    assert solved["tfull"].bucketed["paddedBrokers"] == 10


PROPOSALS = {"spike": _spike, "death": _death, "add": _add}


@pytest.fixture(scope="module")
def proposals(solved):
    """{case: (jax outcome, port outcome, port scratch solve of the subset,
    the armed entry's tensors before, after)}. The scratch solves run on a
    second optimizer, so the armed one's prep cache keeps its entry."""
    scratch_opt = topt.GoalOptimizer(settings=topt.SERVICE_SETTINGS, device="cpu")
    entry = solved["to"].prepared_entry(solved["tm"], solved["topts"])
    out = {}
    for case, perturb in PROPOSALS.items():
        before = [t.clone() for t in (*entry[1], *entry[3])]
        jl, tl = _lanes(solved)
        new = perturb(_arrays())
        jout = jl.propose(solved["jm"]._replace(**new), generation=2)
        tout = tl.propose(from_numpy(new), generation=2)
        scratch = scratch_opt.optimizations(from_numpy(new), list(tout.affected),
                                            raise_on_hard_failure=False)
        after = [t.clone() for t in (*entry[1], *entry[3])]
        out[case] = (jout, tout, scratch, before, after, tl)
    return out


@pytest.mark.parametrize("case", list(PROPOSALS))
def test_lane_proposal_equals_jax_lane(proposals, case):
    jout, tout = proposals[case][:2]
    assert jout.ok and tout.ok, (jout.fallback_reason, tout.fallback_reason)
    assert tout.affected == jout.affected and tout.goals_skipped == jout.goals_skipped
    assert [_delta_key(d) for d in tout.deltas] == [_delta_key(d) for d in jout.deltas]
    goals = list(tout.affected)
    assert tout.result.provenance.digest(goals=goals) == jout.result.provenance.digest(goals=goals)
    assert np.array_equal(tout.result.final_assignment, np.asarray(jout.result.final_assignment))
    assert tout.result.bucketed == jout.result.bucketed and tout.result.bucketed["incremental"]
    assert tout.result.provenance.meta["bucket"] == jout.result.provenance.meta["bucket"]


@pytest.mark.parametrize("case", list(PROPOSALS))
def test_lane_proposal_equals_scratch_solve_of_the_subset(proposals, solved, case):
    _, tout, scratch = proposals[case][:3]
    goals = list(tout.affected)
    assert tout.result.provenance.digest(goals=goals) == scratch.provenance.digest(goals=goals)
    assert np.array_equal(tout.result.final_assignment, scratch.final_assignment)
    unaffected = [n for n in solved["names"] if n not in tout.affected]
    assert tout.result.provenance.digest(goals=unaffected)["moves"] == 0
    # the scoped goals did work, and each case scopes as its kind says
    assert tout.result.provenance.digest(goals=goals)["moves"] > 0
    assert len(goals) == {"spike": 10, "death": 15, "add": 5}[case]


@pytest.mark.parametrize("case", list(PROPOSALS))
def test_armed_prep_entry_is_unchanged_after_propose(proposals, case):
    before, after = proposals[case][3:5]
    assert len(before) == len(after) and all(
        _bits_equal(x, y) for x, y in zip(before, after))


def test_death_evacuates_the_broker(proposals):
    final = proposals["death"][1].result.final_assignment
    assert not (final == 5).any()


def test_lane_state_after_a_proposal(proposals, solved):
    tl = proposals["add"][5]
    st = tl.state()
    assert st["armed"] and st["generation"] == 2 and st["validPartitions"] == 192
    assert st["bucket"] == "P192-B80-T20-RF2" and st["lastOutcome"]["ok"]
    assert st["lastOutcome"]["deltasByKind"] == {tinc.DELTA_PART_ADD: 2}
    # a stale monitor generation after the lane advanced
    stale = tl.propose(from_numpy(_add(_arrays())), generation=1)
    assert stale.fallback_reason == tinc.FALLBACK_STALE_GENERATION


# -- fallbacks ---------------------------------------------------------------------


FALLBACKS = {
    "no-deltas": (lambda f: f, {}),
    "shape-rf": (_wider, {}),
    "shape-brokers": (_drop_broker, {}),
    "structural": (lambda f: dict(f, broker_capacity=f["broker_capacity"] * np.float32(2)), {}),
    "structural-shift": (_row_shift, {}),
    "topic-delete": (_topic_delete, {}),
    "too-many-deltas": (_spike, dict(max_deltas=3)),
    "shape-bucket": (lambda f: _add(f, rows=((0, 1), (2, 3), (4, 5))), {}),
    "shape-topics": (lambda f: _add(f, rows=((0, 1),), topic=20), {}),
    "stale-generation": (_spike, dict(generation=0)),
}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_lane_fallback_equals_jax(solved, case):
    perturb, kw = FALLBACKS[case]
    config = tinc.IncrementalConfig(max_deltas=kw.get("max_deltas", 64))
    jl, tl = _lanes(solved, config)
    new = perturb(_arrays())
    gen = kw.get("generation", 2)
    jout = jl.propose(solved["jm"]._replace(**new), generation=gen)
    tout = tl.propose(from_numpy(new), generation=gen)
    assert not tout.ok and tout.fallback_reason == jout.fallback_reason
    assert tout.summary() == dict(jout.summary(), durationS=tout.summary()["durationS"])


def test_disabled_and_unarmed_lanes_fall_back():
    disabled = tinc.IncrementalLane(topt.GoalOptimizer(device="cpu"),
                                    tinc.IncrementalConfig(enabled=False))
    m = from_numpy(_small())
    assert disabled.arm(m, tctx.OptimizationOptions(), ["RackAwareGoal"]) is False
    assert disabled.propose(m).fallback_reason == tinc.FALLBACK_DISABLED
    lane = tinc.IncrementalLane(topt.GoalOptimizer(device="cpu"))
    # no solve ran on this optimizer: its prep cache has no entry to arm from
    assert lane.arm(m, tctx.OptimizationOptions(), []) is False
    out = lane.propose(m)
    assert out.fallback_reason == tinc.FALLBACK_NOT_ARMED
    assert lane.state()["armed"] is False
    assert lane.state()["lastOutcome"]["fallbackReason"] == tinc.FALLBACK_NOT_ARMED


def test_options_fallback_equals_jax(solved):
    """A partition add under an armed exclusion mask (the JAX lane's
    `_eligibility`; the port's solves refuse the option, so the armed state is
    made by hand)."""
    tl = _lanes(solved)[1]
    armed = dataclasses.replace(tl._armed, options=tctx.OptimizationOptions(
        excluded_partitions=np.zeros(190, dtype=bool)))
    deltas = [tinc.ModelDelta(kind=tinc.DELTA_PART_ADD, row=190, topic=1,
                              load=np.zeros(6, np.float32))]
    jarmed = dataclasses.replace(armed, options=jopt.OptimizationOptions(
        excluded_partitions=np.zeros(190, dtype=bool)))
    assert tl._eligibility(armed, deltas) == tinc.FALLBACK_OPTIONS == \
        jinc.IncrementalLane._eligibility(None, jarmed, deltas, None)


def test_lane_base_masks_are_the_valid_brokers(solved):
    tl = _lanes(solved)[1]
    want = torch.arange(80) < 70
    assert torch.equal(tl._armed.base_replica_dst, want)
    assert torch.equal(tl._armed.base_leadership_dst, want)
    assert tl._armed.pmodel.num_brokers == 80 and tl._armed.p_valid == 190


def test_jax_static_ctx_of_the_lane_equals_the_port(contexts):
    for field in contexts["ts"]._fields:
        assert _bits_equal(contexts["js"]._asdict()[field], getattr(contexts["ts"], field)), field
    assert dataclasses.asdict(contexts["tdims"]) == dataclasses.asdict(contexts["jdims"])
