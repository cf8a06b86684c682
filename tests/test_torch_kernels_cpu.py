"""The plain PyTorch versions of kernels K1-K4 against the JAX functions they
replace, on the same seeded numpy inputs (CPU).

Tolerances: integers exact; floats bit-equal. Both sides sum each segment in
ascending index order and do the same IEEE float32 operations, with XLA:CPU's
fused multiply-adds and tanh reproduced by common/xla_math.py.
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


# -- slice 2: the soft goals' K3 cases, K4's two-leg waves, K5, K6 ------------------

STACK_IDS = [g.name for g in jgoals(None)]


def _stack_tables(ctx, n_priors):
    jt = jacc.build_tables(jgoals(None)[:n_priors], ctx["js"], ctx["ja"], ctx["jd"])
    tt = tacc.build_tables(tgoals(None)[:n_priors], ctx["ts"], ctx["ta"], ctx["td"])
    return jt, tt


def _jitted_score(ctx, jgoal):
    """score_batch as the JAX optimizer runs it: jitted, so XLA fuses its
    multiply-adds (eager JAX rounds them twice)."""
    return jax.jit(lambda act, gs, t: jacc.score_batch(ctx["js"], ctx["ja"], act, jgoal, gs, t))


@pytest.mark.parametrize("gi", range(6, 15), ids=STACK_IDS[6:])
def test_k3_soft_goals_equal_jax(ctx, gi):
    """Each soft goal's acceptance and score on the drain grid and the
    promotion grid, under its priors' tables and under the whole stack's
    (usage bands on): finite masks and scores exact."""
    jgoal, tgoal = jgoals(None)[gi], tgoals(None)[gi]
    jscore = _jitted_score(ctx, jgoal)
    jgs = jgoal.prepare(ctx["js"], ctx["ja"], ctx["jd"])
    tgs = tgoal.prepare(ctx["ts"], ctx["ta"], ctx["td"])
    total = 0
    for n_priors in (gi, 15):
        jt, tt = _stack_tables(ctx, n_priors)
        if n_priors == 15:
            assert bool(tt.band_on.all())
        for seed in (1, 2, 3):
            p, slot, dst = _grid_inputs(ctx, seed)
            act = jact.build_selected(ctx["js"].part_load, ctx["ja"].assignment, jnp.asarray(p),
                                      jnp.int32(jact.KIND_MOVE), jnp.asarray(slot),
                                      jnp.asarray(dst))
            js_ = jscore(act, jgs, jt)
            ts_ = score_candidates_plain(ctx["ts"], ctx["ta"], tt, tgoal, tgs, torch.from_numpy(p),
                                         KIND_MOVE, torch.from_numpy(slot), torch.from_numpy(dst))
            total += _compare_scores(jgoal.name, js_, ts_)
        lb = jact.make_leadership_batch(ctx["js"].part_load, ctx["ja"].assignment)
        js_ = jnp.broadcast_to(jscore(lb, jgs, jt), lb.dst.shape)
        ts_ = score_candidates_plain(ctx["ts"], ctx["ta"], tt, tgoal, tgs,
                                     *leadership_grid(ctx["ta"].assignment))
        total += _compare_scores(jgoal.name, js_, ts_)
    assert total > 0, "the grids should hold acceptable candidates"


def _random_leg(rng, a, n, kind_prob, b):
    p = rng.integers(0, a.shape[0], n).astype(np.int32)
    kind = (rng.random(n) < kind_prob).astype(np.int32)
    slot = np.where(kind == 1, rng.integers(1, a.shape[1], n),
                    rng.integers(0, a.shape[1], n)).astype(np.int32)
    dst = np.where(kind == 1, a[p, slot], rng.integers(0, b, n)).astype(np.int32)
    return p, kind, slot, dst


@pytest.mark.parametrize("form", ["swaps", "relays", "wide"])
def test_k4_two_leg_waves_equal_jax(ctx, form):
    """N = 2,600 entries with integer-valued scores (forced ties): swaps
    (two moves, both hosts and both partitions claimed), relays (two
    promotions, a third broker claimed too) and a wide single-leg wave.
    Selection and every applied aggregate exact."""
    rng = np.random.default_rng({"swaps": 11, "relays": 12, "wide": 13}[form])
    a = ctx["arrays"]["assignment"]
    n, b = 2600, ctx["jd"].num_brokers
    pl, ja = ctx["js"].part_load, ctx["ja"]
    leg1 = _random_leg(rng, a, n, 1.0 if form == "relays" else (0.4 if form == "wide" else 0.0), b)
    legs = [leg1]
    if form != "wide":
        p2, kind2, slot2, dst2 = _random_leg(rng, a, n, 1.0 if form == "relays" else 0.0, b)
        if form == "swaps":  # the return leg lands on leg 1's source
            dst2 = a[leg1[0], leg1[2]]
        legs.append((p2, kind2, slot2, dst2.astype(np.int32)))
    acts = [jact.build_selected(pl, ja.assignment, *(jnp.asarray(x) for x in leg)) for leg in legs]
    score = rng.integers(0, 6, n).astype(np.float32)
    ok = rng.random(n) < 0.8
    for act in acts:
        ok &= np.asarray(act.valid)
    host = ctx["js"].broker_host
    sel = jctx.wave_select(
        jnp.asarray(score), acts[0].src, acts[0].dst, host[acts[0].dst], jnp.asarray(ok), b,
        ctx["jd"].num_hosts, dst_host2=host[acts[1].dst] if form != "wide" else None,
        parts=tuple(act.p for act in acts), num_partitions=ctx["jd"].num_partitions,
        brokers3=acts[1].dst if form == "relays" else None)
    tag = jctx.make_touch_tag(5, 2)
    for act in acts:
        ja = jctx.apply_actions_batch(ctx["js"], ja, act, sel, tag=tag)
    ta2 = _clone(ctx["ta"])
    tleg2 = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in legs[1]) if form != "wide" else None
    tsel = apply_wave_plain(ctx["ts"], ta2, *(torch.from_numpy(x) for x in leg1),
                            torch.from_numpy(score), torch.from_numpy(ok),
                            tctx.make_touch_tag(5, 2), tleg2,
                            brokers3=form == "relays")
    assert _bits_equal(sel, tsel)
    assert int(np.asarray(sel).sum()) >= 3
    for f in ta2._fields:
        assert _bits_equal(ja._asdict()[f], ta2._asdict()[f]), f


def _closure(fn, name):
    """A function a JAX round builder closes over (its nested validate)."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[name]


def _slots_on(a, broker, rng, n):
    where = np.argwhere(a == broker)
    pick = where[rng.integers(0, len(where), n)]
    return pick[:, 0].astype(np.int32), pick[:, 1].astype(np.int32)


def test_k5_swap_tables_acceptance_equals_jax(ctx):
    rng = np.random.default_rng(21)
    a = ctx["arrays"]["assignment"]
    n, b = 3000, ctx["jd"].num_brokers
    hot = rng.integers(0, b, n)
    cold = rng.integers(0, b, n)
    p1, s1 = np.zeros(n, np.int32), np.zeros(n, np.int32)
    p2, s2 = np.zeros(n, np.int32), np.zeros(n, np.int32)
    for i in range(n):
        p1[i:i + 1], s1[i:i + 1] = _slots_on(a, hot[i], rng, 1)
        p2[i:i + 1], s2[i:i + 1] = _slots_on(a, cold[i], rng, 1)
    jt, tt = _stack_tables(ctx, 15)
    kind = jnp.int32(jact.KIND_MOVE)
    pl = ctx["js"].part_load
    j1 = jact.build_selected(pl, ctx["ja"].assignment, jnp.asarray(p1), kind, jnp.asarray(s1),
                             jnp.asarray(cold.astype(np.int32)))
    j2 = jact.build_selected(pl, ctx["ja"].assignment, jnp.asarray(p2), kind, jnp.asarray(s2),
                             jnp.asarray(hot.astype(np.int32)))
    want = np.asarray(jacc.swap_tables_acceptance(ctx["js"], jt, ctx["ja"], j1, j2))
    from cruise_control_torch.analyzer.actions import build_selected as tbuild

    tk = torch.tensor(KIND_MOVE, dtype=torch.int32)
    t1 = tbuild(ctx["ts"].part_load, ctx["ta"].assignment, torch.from_numpy(p1), tk,
                torch.from_numpy(s1), torch.from_numpy(cold.astype(np.int32)))
    t2 = tbuild(ctx["ts"].part_load, ctx["ta"].assignment, torch.from_numpy(p2), tk,
                torch.from_numpy(s2), torch.from_numpy(hot.astype(np.int32)))
    got = tacc.swap_tables_acceptance(ctx["ts"], tt, ctx["ta"], t1, t2).numpy()
    assert np.array_equal(want, got)
    assert 0 < want.sum() < n


def _k5_compare(jvalidate, tvalidate, ctx, jgs, tgs, cells, n_priors=15):
    jt, tt = _stack_tables(ctx, n_priors)
    jfn = jax.jit(lambda agg, t, gs, *c: jvalidate(ctx["js"], agg, t, gs, *c)[:2])
    ok, imp = jfn(ctx["ja"], jt, jgs, *(jnp.asarray(c) for c in cells))
    want = np.where(np.asarray(ok), np.asarray(imp), -np.inf).astype(np.float32)
    got = tvalidate(ctx["ts"], ctx["ta"], tt, tgs, *(torch.from_numpy(c) for c in cells)).numpy()
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    assert _bits_equal(want, got)
    return int(np.isfinite(want).sum())


def test_k5_topic_swap_validation_equals_jax(ctx):
    from cruise_control_torch.analyzer.drain import topic_swap_validate

    rng = np.random.default_rng(22)
    a = ctx["arrays"]["assignment"]
    b_count = ctx["jd"].num_brokers
    jgoal, tgoal = jgoals(None)[12], tgoals(None)[12]
    jfn = _closure(jdrain.make_topic_swap_round(jgoal, ctx["jd"], 24, 8, 8, 8), "validate")
    jgs = jgoal.prepare(ctx["js"], ctx["ja"], ctx["jd"])
    tgs = tgoal.prepare(ctx["ts"], ctx["ta"], ctx["td"])
    n = 4000
    b = rng.integers(0, b_count, n).astype(np.int32)
    d = rng.integers(0, b_count, n).astype(np.int32)
    cells = [np.zeros(n, np.int32) for _ in range(4)]
    for i in range(n):
        cells[0][i], cells[1][i] = (x[0] for x in _slots_on(a, b[i], rng, 1))
        cells[2][i], cells[3][i] = (x[0] for x in _slots_on(a, d[i], rng, 1))
    p1, s1, p2, s2 = cells
    # stale cells: a replica no longer on its broker
    s1[:200] = (s1[:200] + 1) % a.shape[1]
    ok = 0
    for n_priors in (12, 15):
        ok += _k5_compare(jfn, topic_swap_validate, ctx, jgs, tgs, (p1, s1, b, p2, s2, d),
                          n_priors)
    assert ok > 0


def test_k5_relay_validation_equals_jax(ctx):
    """Random relays and relays whose second leg lands back on the first
    leg's source (e == b, the pure leadership swap)."""
    from cruise_control_torch.analyzer.drain import relay_validate

    rng = np.random.default_rng(23)
    a = ctx["arrays"]["assignment"]
    jgoal, tgoal = jgoals(None)[14], tgoals(None)[14]
    jfn = _closure(jdrain.make_leadership_relay_round(jgoal, ctx["jd"], 24, 4, 8, 8), "validate")
    jgs = jgoal.prepare(ctx["js"], ctx["ja"], ctx["jd"])
    tgs = tgoal.prepare(ctx["ts"], ctx["ta"], ctx["td"])
    rows = []
    for p1 in range(a.shape[0]):
        for s1 in range(1, a.shape[1]):
            d = a[p1, s1]
            if d < 0 or a[p1, 0] < 0:
                continue
            led_by_d = np.nonzero(a[:, 0] == d)[0]
            for p2 in led_by_d[:3]:
                for s2 in range(1, a.shape[1]):
                    rows.append((p1, s1, a[p1, 0], p2, s2, d))
    cells = np.asarray(rows, dtype=np.int32)
    eb = a[cells[:, 3], cells[:, 4]] == cells[:, 2]
    assert eb.sum() > 0, "the grid should hold e == b relays"
    pick = np.concatenate([np.nonzero(eb)[0],
                           rng.choice(np.nonzero(~eb)[0], 3000, replace=False)])
    cells = [np.ascontiguousarray(cells[pick, j]) for j in range(6)]
    n_ok = 0
    for n_priors in (0, 14):
        n_ok += _k5_compare(jfn, relay_validate, ctx, jgs, tgs, cells, n_priors)
    assert n_ok > 0


def test_k6_pair_picks_equal_jax(ctx):
    """Pairs on distinct brokers, half naming a topic the broker holds and
    half any topic (pairs the round would mark not ok): exact, for k = 2
    and 4."""
    from cruise_control_torch.kernels.pair_picks import pair_picks_plain

    rng = np.random.default_rng(24)
    a = ctx["arrays"]["assignment"]
    topic = ctx["arrays"]["topic_id"]
    pair_b = rng.permutation(ctx["jd"].num_brokers)[:16].astype(np.int32)
    held = [topic[np.argwhere(a == x)[rng.integers(0, 5)][0]] for x in pair_b[:8]]
    pair_t = np.asarray(held + list(rng.integers(0, ctx["jd"].num_topics, 8)), dtype=np.int32)
    for k in (2, 4):
        want = jdrain.pair_replica_picks(ctx["js"], ctx["ja"], jnp.asarray(pair_t),
                                         jnp.asarray(pair_b), k, ctx["jd"].num_topics,
                                         ctx["jd"].num_brokers)
        got = pair_picks_plain(ctx["ta"].assignment, ctx["ts"].topic_id,
                               ctx["ts"].movable_partition, torch.from_numpy(pair_t),
                               torch.from_numpy(pair_b), k, ctx["jd"].num_brokers)
        for x, y in zip(want, got):
            assert _bits_equal(x, y)
        assert np.asarray(want[2]).any() and not np.asarray(want[2]).all()
