"""One round of each slice-2 engine in the port against the JAX package's
jitted round on the same state and tables (CPU): the bulk count planner, the
replica swaps, the topic goal's pair drain and topic swaps, and the
leadership relays. Every aggregate after the round (the assignment and the
touch tags included) and the `applied` flag must be equal, and each case is
chosen so that the round applies at least one action.

The cluster is fixture C of tests/test_torch_stack.py: 32 brokers, the bulk
planner's floor and the widest axis XLA:CPU sums in index order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import acceptance as jacc
from cruise_control_tpu.analyzer import bulk as jbulk
from cruise_control_tpu.analyzer import context as jctx
from cruise_control_tpu.analyzer import drain as jdrain
from cruise_control_tpu.analyzer import swaps as jswaps
from cruise_control_tpu.analyzer.goals import goals_by_priority as jgoals
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.analyzer import acceptance as tacc
from cruise_control_torch.analyzer import bulk as tbulk
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.analyzer import drain as tdrain
from cruise_control_torch.analyzer import optimizer as topt
from cruise_control_torch.analyzer import swaps as tswaps
from cruise_control_torch.analyzer.goals import goals_by_priority as tgoals
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.models.flat_model import from_numpy

FIXTURE_C = jgen.ClusterProperty(num_racks=4, num_brokers=32, num_topics=80,
                                 mean_partitions_per_topic=10, replication_factor=3,
                                 num_dead_brokers=2, load_distribution="pareto",
                                 mean_utilization=0.5)
GOAL_INDEX = {g.name: i for i, g in enumerate(jgoals(None))}


def _bits_equal(a, b):
    a = np.asarray(a)
    b_ = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.float32:
        return a.shape == b_.shape and np.array_equal(a.view(np.int32), b_.view(np.int32))
    return a.shape == b_.shape and np.array_equal(a, b_)


@pytest.fixture(scope="module")
def ctx():
    m = jgen.random_cluster(42, FIXTURE_C)
    arrays = {k: np.asarray(v) for k, v in m._asdict().items()}
    jd = jctx.dims_of(m)
    js = jctx.build_static_ctx(m, JConstraint.default(), jd)
    ja = jctx.compute_aggregates(js, m.assignment, jd)
    tm = from_numpy(arrays)
    td = tctx.dims_of(tm)
    ts = tctx.build_static_ctx(tm, TConstraint.default(), td)
    ta = tctx.compute_aggregates(ts, tm.assignment, td)
    return dict(jd=jd, js=js, ja=ja, td=td, ts=ts, ta=ta)


def _setup(ctx, name, n_priors):
    gi = GOAL_INDEX[name]
    jg, tg = jgoals(None)[gi], tgoals(None)[gi]
    jt = jacc.build_tables(jgoals(None)[:n_priors], ctx["js"], ctx["ja"], ctx["jd"])
    tt = tacc.build_tables(tgoals(None)[:n_priors], ctx["ts"], ctx["ta"], ctx["td"])
    jgs = jg.prepare(ctx["js"], ctx["ja"], ctx["jd"])
    tgs = tg.prepare(ctx["ts"], ctx["ta"], ctx["td"])
    return jg, tg, jt, tt, jgs, tgs


def _compare(ctx, jagg, japplied, tagg, tapplied):
    assert bool(japplied) and bool(tapplied), "the round should apply at least one action"
    for f in jagg._fields:
        assert _bits_equal(jagg._asdict()[f], tagg._asdict()[f]), f
    assert (np.asarray(jagg.assignment) != np.asarray(ctx["ja"].assignment)).any()


def _clone(agg):
    return type(agg)(*(t.clone() for t in agg))


@pytest.mark.parametrize("name, n_priors, rnd", [
    ("ReplicaDistributionGoal", 6, 3),
    ("LeaderReplicaDistributionGoal", 6, 1),
    ("LeaderBytesInDistributionGoal", 6, 2),
])
def test_bulk_count_round_equals_jax(ctx, name, n_priors, rnd):
    jg, tg, jt, tt, jgs, tgs = _setup(ctx, name, n_priors)
    jfn = jax.jit(jbulk.make_bulk_count_round(jg, ctx["jd"], 8, 16))
    jagg, japplied = jfn(ctx["js"], ctx["ja"], jt, jgs,
                         jg.drain_contrib(ctx["js"], jgs, ctx["ja"]), jnp.int32(rnd))
    ta = _clone(ctx["ta"])
    tfn = tbulk.make_bulk_count_round(tg, ctx["td"], 8, 16)
    ta, tapplied = tfn(ctx["ts"], ta, tt, tgs, tg.drain_contrib(ctx["ts"], tgs, ta), rnd)
    _compare(ctx, jagg, japplied, ta, tapplied)


@pytest.mark.parametrize("name, n_priors", [
    ("DiskUsageDistributionGoal", 8),
    ("CpuUsageDistributionGoal", 11),
])
def test_swap_round_equals_jax(ctx, name, n_priors):
    jg, tg, jt, tt, _, _ = _setup(ctx, name, n_priors)
    width = topt._swap_width(ctx["jd"].num_brokers, 8)
    jfn = jax.jit(jswaps.make_swap_round(jg, (), ctx["jd"], width, 8, 4, apply_waves=8))
    jagg, japplied = jfn(ctx["js"], ctx["ja"], jt, jg.drain_contrib(ctx["js"], None, ctx["ja"]),
                         jnp.int32(4))
    ta = _clone(ctx["ta"])
    tfn = tswaps.make_swap_round(tg, ctx["td"], width, 8, 4, apply_waves=8)
    ta, tapplied = tfn(ctx["ts"], ta, tt, tg.drain_contrib(ctx["ts"], None, ta), 4)
    _compare(ctx, jagg, japplied, ta, tapplied)


@pytest.mark.parametrize("rnd", [0, 5])
def test_pair_drain_round_equals_jax(ctx, rnd):
    jg, tg, jt, tt, jgs, tgs = _setup(ctx, "TopicReplicaDistributionGoal", 12)
    jfn = jax.jit(jdrain.make_pair_drain_round(jg, ctx["jd"], 512, 8))
    jagg, japplied = jfn(ctx["js"], ctx["ja"], jt, jgs, None, jnp.int32(rnd))
    ta = _clone(ctx["ta"])
    ta, tapplied = tdrain.make_pair_drain_round(tg, ctx["td"], 512, 8)(
        ctx["ts"], ta, tt, tgs, None, rnd)
    _compare(ctx, jagg, japplied, ta, tapplied)


@pytest.mark.parametrize("rnd", [0, 1])
def test_topic_swap_round_equals_jax(ctx, rnd):
    """Both candidate pages (the round's parity picks the pair's first or
    second replica)."""
    jg, tg, jt, tt, jgs, tgs = _setup(ctx, "TopicReplicaDistributionGoal", 12)
    jfn = jax.jit(jdrain.make_topic_swap_round(jg, ctx["jd"], 512, 16, 8, 8))
    jagg, japplied = jfn(ctx["js"], ctx["ja"], jt, jgs, jnp.int32(rnd))
    ta = _clone(ctx["ta"])
    ta, tapplied = tdrain.make_topic_swap_round(tg, ctx["td"], 512, 16, 8, 8)(
        ctx["ts"], ta, tt, tgs, rnd)
    _compare(ctx, jagg, japplied, ta, tapplied)


@pytest.mark.parametrize("n_priors, rnd", [(0, 0), (13, 3)])
def test_leadership_relay_round_equals_jax(ctx, n_priors, rnd):
    jg, tg, jt, tt, jgs, tgs = _setup(ctx, "LeaderBytesInDistributionGoal", n_priors)
    jfn = jax.jit(jdrain.make_leadership_relay_round(jg, ctx["jd"], 512, 4, 8, 8))
    jagg, japplied = jfn(ctx["js"], ctx["ja"], jt, jgs, jnp.int32(rnd))
    ta = _clone(ctx["ta"])
    ta, tapplied = tdrain.make_leadership_relay_round(tg, ctx["td"], 512, 4, 8, 8)(
        ctx["ts"], ta, tt, tgs, rnd)
    _compare(ctx, jagg, japplied, ta, tapplied)


def test_round_jitter_equals_jax():
    for rnd in (0, 1, 63, 1000):
        want = np.asarray(jax.jit(lambda r: jdrain.round_jitter(199_518, r))(jnp.int32(rnd)))
        assert _bits_equal(want, tdrain.round_jitter(199_518, rnd, "cpu"))


def test_rank_paired_destinations_equals_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        key = rng.integers(-3, 4, 64).astype(np.float32)
        key[rng.random(64) < 0.3] = -np.inf
        valid = rng.random(64) < 0.5
        off = int(rng.integers(0, 40))
        want = jctx.rank_paired_destinations(jnp.asarray(valid), jnp.asarray(key), off)
        got = tctx.rank_paired_destinations(torch.from_numpy(valid), torch.from_numpy(key), off)
        assert _bits_equal(want, got)
