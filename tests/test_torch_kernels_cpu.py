"""The plain PyTorch versions of kernels K1-K4 against the JAX functions they
replace, on the same seeded numpy inputs (CPU).

Tolerances: integers exact; floats bit-equal (both sides sum each segment in
ascending index order and do the same IEEE float32 operations); K3 scores of
RackAwareGoal and ReplicaCapacityGoal to rtol 1e-6, because XLA:CPU's tanh
and torch.tanh differ by a few ulp, and every other K3 score exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import acceptance as jacc
from cruise_control_tpu.analyzer import actions as jact
from cruise_control_tpu.analyzer import context as jctx
from cruise_control_tpu.analyzer import drain as jdrain
from cruise_control_tpu.analyzer.goals import goals_by_priority as jgoals
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.models import generators as jgen
from cruise_control_tpu.models.flat_model import FlatClusterModel as JModel
from cruise_control_torch.analyzer import acceptance as tacc
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.analyzer.actions import KIND_MOVE, leadership_grid
from cruise_control_torch.analyzer.drain import top_k
from cruise_control_torch.analyzer.goals import HARD_GOAL_NAMES
from cruise_control_torch.analyzer.goals import goals_by_priority as tgoals
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.kernels.apply_wave import apply_wave_plain
from cruise_control_torch.kernels.broker_topk import broker_topk_plain
from cruise_control_torch.kernels.score_candidates import score_candidates_plain
from cruise_control_torch.kernels.segment_aggregates import segment_aggregates_plain
from cruise_control_torch.models.flat_model import from_numpy

TANH_GOALS = ("RackAwareGoal", "ReplicaCapacityGoal")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits_equal(a, b):
    a, b = _np(a), _np(b)
    if a.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def ctx():
    """A small rack-aware pareto cluster with 2 dead brokers, two brokers per
    host, some partitions at RF 2 (empty slot 2) and a replica cap that a few
    brokers exceed. Both packages get the same numpy arrays."""
    prop = jgen.ClusterProperty(num_racks=4, num_brokers=24, num_topics=60,
                                mean_partitions_per_topic=10.0, replication_factor=3,
                                num_dead_brokers=2, load_distribution="pareto",
                                mean_utilization=0.5)
    arrays = {k: np.asarray(v).copy() for k, v in jgen.random_cluster(42, prop)._asdict().items()}
    rng = np.random.default_rng(0)
    arrays["assignment"][rng.random(arrays["assignment"].shape[0]) < 0.1, 2] = -1
    arrays["broker_host"] = (np.arange(24) // 2).astype(np.int32)
    counts = np.bincount(arrays["assignment"][arrays["assignment"] >= 0], minlength=24)
    cap = int(np.percentile(counts, 75))

    jc = JConstraint.default()
    jc = dataclasses.replace(jc, max_replicas_per_broker=cap)
    tc = dataclasses.replace(TConstraint.default(), max_replicas_per_broker=cap)
    jm = JModel(**arrays)
    tm = from_numpy(arrays)
    jd, td = jctx.dims_of(jm), tctx.dims_of(tm)
    assert dataclasses.asdict(jd) == dataclasses.asdict(td)
    js = jctx.build_static_ctx(jm, jc, jd)
    ts = tctx.build_static_ctx(tm, tc, td)
    ja = jctx.compute_aggregates(js, jnp.asarray(arrays["assignment"]), jd)
    ta = tctx.compute_aggregates(ts, tm.assignment, td)
    return dict(arrays=arrays, jd=jd, td=td, js=js, ts=ts, ja=ja, ta=ta)


def test_static_ctx_equals_jax(ctx):
    for f in ctx["ts"]._fields:
        assert _bits_equal(ctx["js"]._asdict()[f], ctx["ts"]._asdict()[f]), f


# -- K1 ---------------------------------------------------------------------------


def test_k1_segment_aggregates_equal_jax(ctx):
    for f in ctx["ta"]._fields:
        assert _bits_equal(ctx["ja"]._asdict()[f], ctx["ta"]._asdict()[f]), f


def test_k1_plain_on_a_second_seed():
    m = jgen.random_cluster(5, jgen.BASELINE_CONFIGS[3])
    arrays = {k: np.asarray(v) for k, v in m._asdict().items()}
    d = jctx.dims_of(m)
    js = jctx.build_static_ctx(m, JConstraint.default(), d)
    ja = jctx.compute_aggregates(js, jnp.asarray(arrays["assignment"]), d)
    tm = from_numpy(arrays)
    out = segment_aggregates_plain(tm.assignment, tm.part_load, tm.topic_id, tm.broker_rack,
                                   tm.broker_host, d.num_brokers, d.num_racks, d.num_hosts,
                                   d.num_topics)
    for f, t in zip(tctx.Aggregates._fields[1:], out):
        assert _bits_equal(ja._asdict()[f], t), f


# -- K2 ---------------------------------------------------------------------------


@pytest.mark.parametrize("heaviest", [True, False])
def test_k2_broker_topk_equals_jax(ctx, heaviest):
    """Forced ties, -0.0 beside +0.0, -inf / +inf / NaN and immovable
    partitions; every output exact, the not-found (p, slot) included."""
    rng = np.random.default_rng(11)
    a = ctx["arrays"]["assignment"]
    contrib = rng.integers(-3, 4, size=a.shape).astype(np.float32)
    contrib[contrib == 0] = np.where(rng.random(int((contrib == 0).sum())) < 0.5, -0.0, 0.0)
    contrib[rng.random(a.shape) < 0.05] = -np.inf
    contrib[rng.random(a.shape) < 0.02] = np.inf
    contrib[rng.random(a.shape) < 0.02] = np.nan
    movable = rng.random(a.shape[0]) > 0.2
    # broker 5 has no candidate at all, broker 6 only three
    contrib[a == 5] = -np.inf
    on6 = np.argwhere(a == 6)
    contrib[tuple(on6[3:].T)] = np.nan
    movable[on6[:3, 0]] = True
    jd = ctx["jd"]
    js = ctx["js"]._replace(movable_partition=jnp.asarray(movable))
    k = 12  # more than some brokers hold, so `valid` goes False
    jp, jsl, jok = jdrain.broker_top_replicas(js, ctx["ja"], jnp.asarray(contrib), k,
                                              jd.num_brokers, heaviest)
    tp, tsl, tok = broker_topk_plain(torch.from_numpy(contrib), ctx["ta"].assignment,
                                     torch.from_numpy(movable), k, jd.num_brokers, heaviest)
    assert not np.asarray(jok).all()
    for x, y in ((jp, tp), (jsl, tsl), (jok, tok)):
        assert _bits_equal(x, y)


# -- K3 ---------------------------------------------------------------------------


def _grid_inputs(ctx, seed):
    rng = np.random.default_rng(seed)
    a = ctx["arrays"]["assignment"]
    dead = np.nonzero(ctx["arrays"]["broker_state"] == 3)[0]
    on_dead = np.nonzero(np.isin(a, dead).any(axis=1))[0]
    v, k, c = 10, 4, 8
    p = rng.integers(0, a.shape[0], size=(v, k, 1)).astype(np.int32)
    p[: v // 2] = rng.choice(on_dead, size=(v // 2, k, 1)).astype(np.int32)
    slot = rng.integers(0, a.shape[1], size=(v, k, 1)).astype(np.int32)
    dst = rng.choice(a.max() + 1, size=(1, 1, c), replace=False).astype(np.int32)
    return p, slot, dst


def _goal_case(ctx, i):
    jg, tg = jgoals(HARD_GOAL_NAMES), tgoals(HARD_GOAL_NAMES)
    jt = jacc.build_tables(jg[:i], ctx["js"], ctx["ja"], ctx["jd"])
    tt = tacc.build_tables(tg[:i], ctx["ts"], ctx["ta"], ctx["td"])
    return jg[i], tg[i], jt, tt


def _compare_scores(name, js_, ts_):
    js_, ts_ = np.asarray(js_), _np(ts_)
    assert js_.shape == ts_.shape
    fin = np.isfinite(js_)
    assert np.array_equal(fin, np.isfinite(ts_)), name
    if name in TANH_GOALS:
        np.testing.assert_allclose(ts_[fin], js_[fin], rtol=1e-6, atol=0)
    else:
        assert _bits_equal(js_[fin], ts_[fin]), name
    return int(fin.sum())


@pytest.mark.parametrize("gi", range(6), ids=HARD_GOAL_NAMES)
def test_k3_move_grid_equals_jax(ctx, gi):
    jgoal, tgoal, jt, tt = _goal_case(ctx, gi)
    total = 0
    for seed in (1, 2, 3):
        p, slot, dst = _grid_inputs(ctx, seed)
        jgs = jgoal.prepare(ctx["js"], ctx["ja"], ctx["jd"])
        tgs = tgoal.prepare(ctx["ts"], ctx["ta"], ctx["td"])
        act = jact.build_selected(ctx["js"].part_load, ctx["ja"].assignment, jnp.asarray(p),
                                  jnp.int32(jact.KIND_MOVE), jnp.asarray(slot), jnp.asarray(dst))
        js_ = jacc.score_batch(ctx["js"], ctx["ja"], act, jgoal, jgs, jt)
        ts_ = score_candidates_plain(ctx["ts"], ctx["ta"], tt, tgoal, tgs, torch.from_numpy(p),
                                     KIND_MOVE, torch.from_numpy(slot), torch.from_numpy(dst))
        total += _compare_scores(jgoal.name, js_, ts_)
    assert total > 0, "the grid should hold acceptable candidates"


@pytest.mark.parametrize("gi", range(6), ids=HARD_GOAL_NAMES)
def test_k3_leadership_grid_equals_jax(ctx, gi):
    jgoal, tgoal, jt, tt = _goal_case(ctx, gi)
    jgs = jgoal.prepare(ctx["js"], ctx["ja"], ctx["jd"])
    tgs = tgoal.prepare(ctx["ts"], ctx["ta"], ctx["td"])
    lb = jact.make_leadership_batch(ctx["js"].part_load, ctx["ja"].assignment)
    js_ = jacc.score_batch(ctx["js"], ctx["ja"], lb, jgoal, jgs, jt)
    js_ = jnp.broadcast_to(js_, lb.dst.shape)
    ts_ = score_candidates_plain(ctx["ts"], ctx["ta"], tt, tgoal, tgs,
                                 *leadership_grid(ctx["ta"].assignment))
    n = _compare_scores(jgoal.name, js_, ts_)
    if jgoal.name in ("NetworkOutboundCapacityGoal", "CpuCapacityGoal"):
        assert n > 0


# -- K4 ---------------------------------------------------------------------------


def _clone(agg):
    return type(agg)(*(t.clone() for t in agg))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k4_apply_wave_equals_jax(ctx, seed):
    """Random waves with integer-valued scores (forced ties) over moves and
    promotions, on brokers that share hosts: the selection and every applied
    aggregate exact."""
    rng = np.random.default_rng(seed)
    a = ctx["arrays"]["assignment"]
    n, r = 96, a.shape[1]
    b = ctx["jd"].num_brokers
    p = rng.integers(0, a.shape[0], n).astype(np.int32)
    kind = (rng.random(n) < 0.4).astype(np.int32)
    slot = np.where(kind == 1, rng.integers(1, r, n), rng.integers(0, r, n)).astype(np.int32)
    dst = np.where(kind == 1, a[p, slot], rng.integers(0, b, n)).astype(np.int32)
    score = rng.integers(0, 4, n).astype(np.float32)
    act = jact.build_selected(ctx["js"].part_load, ctx["ja"].assignment, jnp.asarray(p),
                              jnp.asarray(kind), jnp.asarray(slot), jnp.asarray(dst))
    ok = np.asarray(act.valid) & (rng.random(n) < 0.8)
    tag = jctx.make_touch_tag(3, seed)
    sel = jctx.wave_select(jnp.asarray(score), act.src, act.dst,
                           ctx["js"].broker_host[act.dst], jnp.asarray(ok), b,
                           ctx["jd"].num_hosts, parts=(act.p,),
                           num_partitions=ctx["jd"].num_partitions)
    ja2 = jctx.apply_actions_batch(ctx["js"], ctx["ja"], act, sel, tag=tag)
    ta2 = _clone(ctx["ta"])
    tsel = apply_wave_plain(ctx["ts"], ta2, torch.from_numpy(p), torch.from_numpy(kind),
                            torch.from_numpy(slot), torch.from_numpy(dst),
                            torch.from_numpy(score), torch.from_numpy(ok),
                            tctx.make_touch_tag(3, seed))
    assert _bits_equal(sel, tsel)
    assert int(np.asarray(sel).sum()) >= 3
    for f in ta2._fields:
        assert _bits_equal(ja2._asdict()[f], ta2._asdict()[f]), f


# -- tie orders the drain round relies on -----------------------------------------


def test_top_k_breaks_ties_by_lowest_index():
    rng = np.random.default_rng(4)
    x = rng.integers(-2, 3, 500).astype(np.float32)
    x[rng.random(500) < 0.3] = -np.inf
    x[rng.random(500) < 0.02] = np.inf
    for k in (1, 7, 64, 500):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = top_k(torch.from_numpy(x), k)
        assert np.array_equal(np.asarray(ji), ti.numpy()), k
        assert _bits_equal(jv, tv)


def test_argmax_of_all_minus_inf_rows_is_index_zero():
    x = np.full((3, 9), -np.inf, dtype=np.float32)
    x[1, 4] = x[1, 6] = 2.0
    assert np.array_equal(np.asarray(jnp.argmax(jnp.asarray(x), axis=1)),
                          torch.argmax(torch.from_numpy(x), dim=1).numpy())
    assert torch.argmax(torch.from_numpy(x), dim=1).tolist() == [0, 4, 0]
