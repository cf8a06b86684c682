"""Every goal's per-broker hooks in the port against the JAX package, on the
same seeded 32-broker cluster (CPU): windows, violations, costs, drain
priorities, source ranks, destination preferences, bulk counts and the
merged acceptance tables, all bit-equal. Float sums follow XLA:CPU's order
(`window_sum`), up to the 766-partition mean of LeaderBytesInDistributionGoal.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import acceptance as jacc
from cruise_control_tpu.analyzer import context as jctx
from cruise_control_tpu.analyzer.goals import goals_by_priority as jgoals
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.analyzer import acceptance as tacc
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.analyzer.goals import SOFT_GOAL_NAMES
from cruise_control_torch.analyzer.goals import goals_by_priority as tgoals
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.models.flat_model import from_numpy

FIXTURE_C = jgen.ClusterProperty(num_racks=4, num_brokers=32, num_topics=80,
                                 mean_partitions_per_topic=10, replication_factor=3,
                                 num_dead_brokers=2, load_distribution="pareto",
                                 mean_utilization=0.5)
GOAL_IDS = [g.name for g in jgoals(None)]


def _bits_equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.float32 and b.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
    return a.shape == b.shape and np.array_equal(a, b)


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


def test_the_default_stack_is_fully_ported():
    assert [g.name for g in tgoals(None)] == GOAL_IDS
    assert all(g.kernel_id is not None for g in tgoals(None))
    assert len({g.kernel_id for g in tgoals(None)}) == 15
    assert len(SOFT_GOAL_NAMES) == 9


@pytest.mark.parametrize("gi", range(15), ids=GOAL_IDS)
def test_goal_hooks_equal_jax(ctx, gi):
    jg, tg = jgoals(None)[gi], tgoals(None)[gi]
    for flag in ("uses_leadership", "count_family", "uses_swaps", "pair_drain",
                 "leadership_swap", "rotate_drain_candidates", "is_hard"):
        assert bool(getattr(jg, flag, False)) == bool(getattr(tg, flag)), flag
    js, ja, ts, ta = ctx["js"], ctx["ja"], ctx["ts"], ctx["ta"]
    jgs = jg.prepare(js, ja, ctx["jd"])
    tgs = tg.prepare(ts, ta, ctx["td"])
    if jgs is not None:
        for f in jgs._fields:
            assert _bits_equal(getattr(jgs, f), getattr(tgs, f)), f
    hooks = ["broker_violation", "cost", "src_rank", "drain_contrib", "dst_preference"]
    if jg.count_family and not getattr(jg, "pair_drain", False):
        hooks.append("bulk_counts")
    for h in hooks:
        jv, tv = getattr(jg, h)(js, jgs, ja), getattr(tg, h)(ts, tgs, ta)
        if h == "bulk_counts":
            # LeaderBytesInDistributionGoal's unit is the mean leader weight
            # over all P = 766 partitions: window_sum takes it in XLA:CPU's
            # order, so it is exact too
            for f in jv._fields:
                assert _bits_equal(getattr(jv, f), getattr(tv, f)), (h, f)
        else:
            assert _bits_equal(jv, tv), h
    jt = jg.contribute_acceptance(js, jgs, jacc.empty_tables(ctx["jd"]))
    tt = tg.contribute_acceptance(ts, tgs, tacc.empty_tables(ctx["td"], "cpu"))
    for f in jt._fields:
        assert _bits_equal(getattr(jt, f), getattr(tt, f)), f


def test_the_whole_stack_tables_equal_jax(ctx):
    jt = jacc.build_tables(jgoals(None), ctx["js"], ctx["ja"], ctx["jd"])
    tt = tacc.build_tables(tgoals(None), ctx["ts"], ctx["ta"], ctx["td"])
    for f in jt._fields:
        assert _bits_equal(getattr(jt, f), getattr(tt, f)), f
    assert bool(tt.band_on.any()), "the usage goals' bands are live on this cluster"
