"""The plain PyTorch versions of kernels K1-K4 against the JAX functions they
replace, on the same seeded numpy inputs (CPU).

Tolerances: integers exact; floats bit-equal. Both sides sum each segment in
ascending index order and do the same IEEE float32 operations, with XLA:CPU's
fused multiply-adds and tanh reproduced by common/xla_math.py.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import topk_cases
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


K2_CASES = topk_cases.NAMES + tuple(f"k={k}" for k in topk_cases.KS)


@pytest.mark.parametrize("name", K2_CASES)
def test_k2_crafted_cases_equal_jitted_jax(name):
    """tests/topk_cases.py, which the card tests hold the kernel to the plain
    version on: ties, signed zeros, brokers with nothing eligible, k beyond a
    broker's count, a broker over 2,048 slots, ascending order, leadership
    masks, 1e9 runs, 3,072 bucketed brokers, k in KS; every output exact
    against jitted JAX."""
    c = topk_cases.case(name)
    k, b, heaviest = c["k"], c["num_brokers"], c["heaviest"]

    @jax.jit
    def jax_side(movable, a, contrib):
        return jdrain.broker_top_replicas(types.SimpleNamespace(movable_partition=movable),
                                          types.SimpleNamespace(assignment=a), contrib, k, b,
                                          heaviest)

    want = jax_side(c["movable"], c["assignment"], c["contrib"])
    got = broker_topk_plain(torch.from_numpy(c["contrib"]), torch.from_numpy(c["assignment"]),
                            torch.from_numpy(c["movable"]), k, b, heaviest)
    assert topk_cases.occurs(name, c, np.asarray(want[2]))
    for x, y in zip(want, got):
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


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_k6_pair_picks_equal_jax(ctx, k):
    """Pairs on distinct brokers, half naming a topic the broker holds and
    half any topic (pairs the round would mark not ok, most with no slot at
    all), through the wrapper: exact against jitted JAX. At k = 4 and 8 most
    rows hold fewer than k slots."""
    from cruise_control_torch.kernels.pair_picks import pair_picks

    rng = np.random.default_rng(24)
    a = ctx["arrays"]["assignment"]
    topic = ctx["arrays"]["topic_id"]
    pair_b = rng.permutation(ctx["jd"].num_brokers)[:16].astype(np.int32)
    held = [topic[np.argwhere(a == x)[rng.integers(0, 5)][0]] for x in pair_b[:8]]
    pair_t = np.asarray(held + list(rng.integers(0, ctx["jd"].num_topics, 8)), dtype=np.int32)
    # the last pair names a topic its broker holds no replica of
    on_last = set(topic[np.nonzero((a == pair_b[-1]).any(axis=1))[0]].tolist())
    pair_t[-1] = min(set(range(ctx["jd"].num_topics)) - on_last)
    jfn = jax.jit(jdrain.pair_replica_picks, static_argnums=(4, 5, 6))
    want = jfn(ctx["js"], ctx["ja"], jnp.asarray(pair_t), jnp.asarray(pair_b), k,
               ctx["jd"].num_topics, ctx["jd"].num_brokers)
    got = pair_picks(ctx["ta"].assignment, ctx["ts"].topic_id, ctx["ts"].movable_partition,
                     torch.from_numpy(pair_t), torch.from_numpy(pair_b), k,
                     ctx["jd"].num_brokers)
    for x, y in zip(want, got):
        assert _bits_equal(x, y)
    found = np.asarray(want[2])
    assert found.any() and not found.all()
    assert (~found.any(axis=1)).any(), "a row with no slot"
    if k >= 4:
        assert (found.any(axis=1) & ~found.all(axis=1)).any(), "a row with fewer than k slots"


def _jax_replica_swap_revalidate(static, agg, tables, gs, res, p1, s1, h, p2, s2, c):
    """The JAX swap round's per-wave re-validation (swaps.py:255-282) as a
    function of its cells: the improvement, -inf where not valid."""
    from cruise_control_tpu.analyzer.swaps import _dist, _slot_contrib

    a = agg.assignment
    cap = jnp.maximum(static.broker_capacity[:, res], 1e-9)
    contrib = _slot_contrib(static, a, res)
    still = (a[p1, s1] == h) & (a[p2, s2] == c)
    still &= ~jnp.any(a[p1] == c[:, None], axis=-1)
    still &= ~jnp.any(a[p2] == h[:, None], axis=-1)
    rack_h, rack_c = static.broker_rack[h], static.broker_rack[c]
    same = (rack_h == rack_c).astype(agg.rack_replica_count.dtype)
    rack_safe = ((agg.rack_replica_count[p1, rack_c] - same) == 0) & (
        (agg.rack_replica_count[p2, rack_h] - same) == 0)
    still &= rack_safe | ~tables.rack_enabled
    u_h, u_c = agg.broker_load[h, res] / cap[h], agg.broker_load[c, res] / cap[c]
    d = contrib[p1, s1] - contrib[p2, s2]
    h0, h1 = _dist(u_h, gs), _dist(u_h - d / cap[h], gs)
    c0, c1 = _dist(u_c, gs), _dist(u_c + d / cap[c], gs)
    improve = h0 + c0 - h1 - c1
    endpoint_ok = (h1 <= h0 + 1e-6) & (c1 <= c0 + 1e-6)
    kind = jnp.full(p1.shape, KIND_MOVE, dtype=jnp.int32)
    mv1 = jact.build_selected(static.part_load, a, p1, kind, s1, c)
    mv2 = jact.build_selected(static.part_load, a, p2, kind, s2, h)
    ok = still & endpoint_ok & (improve > 1e-6) & jacc.swap_tables_acceptance(
        static, tables, agg, mv1, mv2)
    return ok, improve


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["replica-swap", "topic-swap", "relay"])
def test_k5_score_swaps_takes_a_python_int_kind(ctx, kind):
    """The K5 wrapper called as the rounds call it, `kind` a Python int (a
    tensor is refused: it would cost a read of the device), against the JAX
    validators: the replica swap's wave re-validation (DiskUsage, :255-282,
    under its priors' tables), the topic swap's (:485) and the relay's
    (:692), with no priors."""
    from cruise_control_torch.kernels.score_swaps import score_swaps

    rng = np.random.default_rng(30 + kind)
    a = ctx["arrays"]["assignment"]
    b_count = ctx["jd"].num_brokers
    n = 4000
    if kind == 2:
        rows = [(p1, s1, a[p1, 0], p2, s2, a[p1, s1])
                for p1 in range(a.shape[0]) for s1 in range(1, a.shape[1])
                if a[p1, s1] >= 0 and a[p1, 0] >= 0
                for p2 in np.nonzero(a[:, 0] == a[p1, s1])[0][:3] for s2 in range(1, a.shape[1])]
        cells = [np.ascontiguousarray(c) for c in np.asarray(rows, dtype=np.int32).T]
    else:
        b = rng.integers(0, b_count, n).astype(np.int32)
        d = rng.integers(0, b_count, n).astype(np.int32)
        c1 = [_slots_on(a, x, rng, 1) for x in b]
        c2 = [_slots_on(a, x, rng, 1) for x in d]
        cells = [np.asarray([x[0][0] for x in c1], np.int32), np.asarray([x[1][0] for x in c1],
                                                                          np.int32), b,
                 np.asarray([x[0][0] for x in c2], np.int32), np.asarray([x[1][0] for x in c2],
                                                                          np.int32), d]
        cells[0][:50] = -1  # masked cells
    gi = (8, 12, 14)[kind]
    jgoal, tgoal = jgoals(None)[gi], tgoals(None)[gi]
    jgs = jgoal.prepare(ctx["js"], ctx["ja"], ctx["jd"])
    tgs = tgoal.prepare(ctx["ts"], ctx["ta"], ctx["td"])
    jt, tt = _stack_tables(ctx, (gi, 0, 0)[kind])
    res = getattr(tgoal, "resource", 0)
    if kind == 0:
        jfn = jax.jit(lambda agg, t, gs, *c: _jax_replica_swap_revalidate(
            ctx["js"], agg, t, gs, res, *c))
    else:
        make = (jdrain.make_topic_swap_round(jgoal, ctx["jd"], 24, 8, 8, 8) if kind == 1
                else jdrain.make_leadership_relay_round(jgoal, ctx["jd"], 24, 4, 8, 8))
        validate = _closure(make, "validate")
        jfn = jax.jit(lambda agg, t, gs, *c: validate(ctx["js"], agg, t, gs, *c)[:2])
    jcells = [jnp.asarray(np.maximum(c, 0)) for c in cells]
    ok, imp = jfn(ctx["ja"], jt, jgs, *jcells)
    want = np.where(np.asarray(ok) & (cells[0] >= 0), np.asarray(imp), -np.inf).astype(np.float32)
    got = score_swaps(kind, ctx["ts"], ctx["ta"], tt, tgs, *(torch.from_numpy(c) for c in cells),
                      resource=res, wave=kind == 0).numpy()
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    assert _bits_equal(want, got)
    assert np.isfinite(want).any()
    with pytest.raises(TypeError):
        score_swaps(torch.tensor(kind), ctx["ts"], ctx["ta"], tt, tgs,
                    *(torch.from_numpy(c) for c in cells), resource=res, wave=kind == 0)


# -- K10 ------------------------------------------------------------------------


def _random_delta_batch(rng, d, n_live, b, p, m):
    """A DeltaBatch as numpy columns: `n_live` rows of mixed kinds, then NOOP
    rows (zeros, as build_delta_batch pads). Targets repeat (the later row
    lands), and some fall outside the axis on either side."""
    cols = {k: np.zeros(d, np.int32) for k in ("kind", "broker", "state", "row", "topic")}
    cols["kind"][:n_live] = rng.integers(1, 4, n_live)
    cols["broker"][:n_live] = rng.integers(-b - 2, b + 2, n_live)
    cols["state"][:n_live] = rng.integers(0, 4, n_live)
    cols["row"][:n_live] = np.where(rng.random(n_live) < 0.7, rng.integers(0, 6, n_live),
                                    rng.integers(-p - 2, p + 2, n_live))
    cols["topic"][:n_live] = rng.integers(0, 60, n_live)
    load = np.zeros((d, m), np.float32)
    load[:n_live] = rng.random((n_live, m), dtype=np.float32)
    return cols, load


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k10_delta_scatter_equals_jax(ctx, seed):
    """Every kind, NOOP rows, repeated targets and indices outside the axes
    against the jitted JAX scatter; every field of the context exact, and the
    input context left as it was."""
    from cruise_control_tpu.analyzer import incremental as jinc
    from cruise_control_torch.analyzer.incremental import DeltaBatch
    from cruise_control_torch.kernels.delta_scatter import delta_scatter_plain

    rng = np.random.default_rng(seed)
    b, (p, m) = ctx["td"].num_brokers, ctx["arrays"]["part_load"].shape
    cols, load = _random_delta_batch(rng, 64, 40, b, p, m)
    base_rep, base_lead = rng.random(b) < 0.8, rng.random(b) < 0.8
    jout = jax.jit(jinc.apply_delta_batch)(
        ctx["js"], jinc.DeltaBatch(**{k: jnp.asarray(v) for k, v in cols.items()},
                                   load=jnp.asarray(load)),
        jnp.asarray(base_rep), jnp.asarray(base_lead))
    before = [t.clone() for t in ctx["ts"]]
    tout = delta_scatter_plain(
        ctx["ts"], DeltaBatch(**{k: torch.from_numpy(v) for k, v in cols.items()},
                              load=torch.from_numpy(load)),
        torch.from_numpy(base_rep), torch.from_numpy(base_lead))
    for f in tout._fields:
        assert _bits_equal(jout._asdict()[f], tout._asdict()[f]), f
    assert all(torch.equal(x, y) for x, y in zip(before, ctx["ts"]))
    assert not _bits_equal(tout.part_load, ctx["ts"].part_load)


def test_k10_delta_scatter_of_noops_is_the_input(ctx):
    from cruise_control_torch.analyzer.incremental import build_delta_batch
    from cruise_control_torch.kernels.delta_scatter import delta_scatter_plain

    ts = ctx["ts"]
    out = delta_scatter_plain(ts, build_delta_batch([], 64, ts.part_load.shape[1]),
                              ts.replica_dst_ok.clone(), ts.leadership_dst_ok.clone())
    for f in ts._fields:
        assert _bits_equal(getattr(ts, f), getattr(out, f)), f


# -- the immigrant term (K3, K5) and K11 -----------------------------------------------


def _immigrant(static, flag: bool):
    if isinstance(static, tctx.StaticCtx):
        return static._replace(only_move_immigrants=torch.tensor(flag))
    return static._replace(only_move_immigrants=jnp.asarray(flag))


@pytest.mark.parametrize("gi", [0, 2, 8, 13], ids=[STACK_IDS[i] for i in (0, 2, 8, 13)])
def test_k3_immigrant_term_equals_jax(ctx, gi):
    """K3's plain version with only_move_immigrants set: the move and
    promotion grids' scores equal the jitted score_batch's, every finite
    cell's source is dead, and the flag masks cells it leaves finite when
    off."""
    jgoal, tgoal = jgoals(None)[gi], tgoals(None)[gi]
    jt, tt = _stack_tables(ctx, gi)
    jgs = jgoal.prepare(ctx["js"], ctx["ja"], ctx["jd"])
    tgs = tgoal.prepare(ctx["ts"], ctx["ta"], ctx["td"])
    dead = ctx["arrays"]["broker_state"] == 3
    finite = {}
    for flag in (False, True):
        js, ts = _immigrant(ctx["js"], flag), _immigrant(ctx["ts"], flag)
        jscore = jax.jit(lambda act, gs, t: jacc.score_batch(js, ctx["ja"], act, jgoal, gs, t))
        n = 0
        for seed in (1, 2, 3):
            p, slot, dst = _grid_inputs(ctx, seed)
            act = jact.build_selected(js.part_load, ctx["ja"].assignment, jnp.asarray(p),
                                      jnp.int32(jact.KIND_MOVE), jnp.asarray(slot),
                                      jnp.asarray(dst))
            want = jscore(act, jgs, jt)
            got = score_candidates_plain(ts, ctx["ta"], tt, tgoal, tgs, torch.from_numpy(p),
                                         KIND_MOVE, torch.from_numpy(slot), torch.from_numpy(dst))
            n += _compare_scores(jgoal.name, want, got)
            if flag:
                src = np.broadcast_to(np.asarray(act.src), got.shape)
                assert dead[src[np.isfinite(got.numpy())]].all()
        lb = jact.make_leadership_batch(js.part_load, ctx["ja"].assignment)
        n += _compare_scores(jgoal.name, jnp.broadcast_to(jscore(lb, jgs, jt), lb.dst.shape),
                             score_candidates_plain(ts, ctx["ta"], tt, tgoal, tgs,
                                                    *leadership_grid(ctx["ta"].assignment)))
        finite[flag] = n
    # the hard goals' finite cells are mostly the dead brokers' evacuations
    # already; the soft goals' are not
    assert finite[True] > 0 and finite[False] >= finite[True]
    assert gi < 6 or finite[False] > finite[True]


def test_k5_immigrant_term_equals_jax(ctx):
    """K5's plain topic-swap and relay validations with only_move_immigrants
    set: every cell is rejected, as in the JAX validates (drain.py:494,
    :704), on cells that pass with the flag off; the replica-swap grid too
    (swaps.py:98-103)."""
    from cruise_control_torch.analyzer.drain import relay_validate, topic_swap_validate
    from cruise_control_torch.analyzer.swaps import replica_swap_grid

    rng = np.random.default_rng(24)
    a = ctx["arrays"]["assignment"]
    b_count = ctx["jd"].num_brokers
    n = 4000
    b = rng.integers(0, b_count, n).astype(np.int32)
    d = rng.integers(0, b_count, n).astype(np.int32)
    cells = [np.zeros(n, np.int32) for _ in range(4)]
    for i in range(n):
        cells[0][i], cells[1][i] = (x[0] for x in _slots_on(a, b[i], rng, 1))
        cells[2][i], cells[3][i] = (x[0] for x in _slots_on(a, d[i], rng, 1))
    swap_cells = (cells[0], cells[1], b, cells[2], cells[3], d)
    rows = [(p1, s1, a[p1, 0], p2, s2, a[p1, s1])
            for p1 in range(a.shape[0]) for s1 in range(1, a.shape[1])
            if a[p1, s1] >= 0 and a[p1, 0] >= 0
            for p2 in np.nonzero(a[:, 0] == a[p1, s1])[0][:3] for s2 in range(1, a.shape[1])]
    relay_cells = tuple(np.ascontiguousarray(c) for c in np.asarray(rows, dtype=np.int32).T)
    for gi, make, tvalidate, grid, n_priors in (
            (12, lambda g: jdrain.make_topic_swap_round(g, ctx["jd"], 24, 8, 8, 8),
             topic_swap_validate, swap_cells, 12),
            (14, lambda g: jdrain.make_leadership_relay_round(g, ctx["jd"], 24, 4, 8, 8),
             relay_validate, relay_cells, 0)):
        jgoal, tgoal = jgoals(None)[gi], tgoals(None)[gi]
        jfn = _closure(make(jgoal), "validate")
        jgs = jgoal.prepare(ctx["js"], ctx["ja"], ctx["jd"])
        tgs = tgoal.prepare(ctx["ts"], ctx["ta"], ctx["td"])
        saved = ctx["js"], ctx["ts"]
        assert _k5_compare(jfn, tvalidate, ctx, jgs, tgs, grid, n_priors) > 0
        ctx["js"], ctx["ts"] = _immigrant(saved[0], True), _immigrant(saved[1], True)
        try:
            assert _k5_compare(jfn, tvalidate, ctx, jgs, tgs, grid, n_priors) == 0
        finally:
            ctx["js"], ctx["ts"] = saved
    disk = tgoals(None)[8]
    gs = disk.prepare(ctx["ts"], ctx["ta"], ctx["td"])
    tt = tacc.empty_tables(ctx["td"], "cpu")
    grid = tuple(torch.from_numpy(x) for x in swap_cells)
    off = replica_swap_grid(ctx["ts"], ctx["ta"], tt, gs, disk.resource, *grid)
    on = replica_swap_grid(_immigrant(ctx["ts"], True), ctx["ta"], tt, gs, disk.resource, *grid)
    assert torch.isfinite(off).any() and not torch.isfinite(on).any()


def test_k11_elect_preferred_plain_equals_jax(ctx):
    """K11's plain version on the cluster's rows, with demoted and dead
    leaders and -1 slots, against the jitted elect_preferred_leaders."""
    from cruise_control_tpu.analyzer.goals.preferred import elect_preferred_leaders as jelect
    from cruise_control_torch.kernels.elect_preferred import elect_preferred_plain

    rng = np.random.default_rng(25)
    a = ctx["arrays"]["assignment"].copy()
    a[rng.random(a.shape) < 0.1] = -1
    st = ctx["arrays"]["broker_state"].copy()
    st[rng.choice(np.nonzero(st == 0)[0], 4, replace=False)] = 2
    js = ctx["js"]._replace(demoted=jnp.asarray(st == 2), dead=jnp.asarray(st == 3))
    want = np.asarray(jax.jit(jelect)(js, jnp.asarray(a)))
    got = elect_preferred_plain(torch.from_numpy(a), torch.from_numpy(st == 2),
                                torch.from_numpy(st == 3)).numpy()
    assert np.array_equal(want, got) and (got != a).any()


# -- the wrappers' refusals (K4, K7, K10, K11) ------------------------------------------


class _OnCard:
    """A CPU tensor that reports itself on a CUDA device: what a wrapper's
    checks read (dtype, shape, rank, contiguity, device), so that its refusal
    runs on the CPU. Nothing here reaches a launch: every case is refused."""

    def __init__(self, t, device="cuda:0"):
        self._t, self.device = t, torch.device(device)

    @property
    def is_cuda(self):
        return self.device.type == "cuda"

    def __getattr__(self, name):
        return getattr(self._t, name)


def _on_card(tup, **swap):
    """The namedtuple `tup` with every tensor reported on cuda:0, then the
    fields in `swap` put in as they are given."""
    fields = {k: _OnCard(v) if isinstance(v, torch.Tensor) else v for k, v in tup._asdict().items()}
    fields.update(swap)
    return type(tup)(**fields)


def _k7_case(ctx, case):
    from cruise_control_torch.kernels.state_fingerprint import state_fingerprint

    ta = ctx["ta"]
    swap = {"dtype": {"leader_count": _OnCard(ta.leader_count.long())},
            "shape": {"replica_count": _OnCard(ta.replica_count[1:])},
            "rank": {"broker_load": _OnCard(ta.broker_load.reshape(-1))},
            "device": {"leader_nw_in": ta.leader_nw_in},
            "other card": {"leader_nw_in": _OnCard(ta.leader_nw_in, "cuda:1")},
            "contiguity": {"broker_load": _OnCard(ta.broker_load.t().contiguous().t())}}[case]
    return lambda: state_fingerprint(_on_card(ta, **swap))


def _k10_case(ctx, case):
    from cruise_control_torch.analyzer.incremental import build_delta_batch
    from cruise_control_torch.kernels.delta_scatter import delta_scatter

    ts = ctx["ts"]
    batch = build_delta_batch([], 64, ts.part_load.shape[1])
    base = _OnCard(ts.replica_dst_ok.clone())
    st_swap, b_swap = {
        "dtype": ({}, {"row": _OnCard(batch.row.long())}),
        "shape": ({"topic_id": _OnCard(ts.topic_id[1:])}, {}),
        "rank": ({}, {"load": _OnCard(batch.load.reshape(-1))}),
        "device": ({"broker_valid": ts.broker_valid}, {}),
        "other card": ({}, {"kind": _OnCard(batch.kind, "cuda:1")}),
        "contiguity": ({"part_load": _OnCard(ts.part_load.t().contiguous().t())}, {}),
    }[case]
    return lambda: delta_scatter(_on_card(ts, **st_swap), _on_card(batch, **b_swap), base, base)


def _k11_case(ctx, case):
    from cruise_control_torch.kernels.elect_preferred import elect_preferred

    a = torch.from_numpy(ctx["arrays"]["assignment"])
    dead = torch.from_numpy(ctx["arrays"]["broker_state"] == 3)
    args = {"dtype": (_OnCard(a.long()), _OnCard(dead), _OnCard(dead)),
            "shape": (_OnCard(a), _OnCard(dead), _OnCard(dead[1:])),
            "rank": (_OnCard(a.reshape(-1)), _OnCard(dead), _OnCard(dead)),
            "device": (_OnCard(a), dead, _OnCard(dead)),
            "other card": (_OnCard(a), _OnCard(dead), _OnCard(dead, "cuda:1")),
            "contiguity": (_OnCard(a.t().contiguous().t()), _OnCard(dead), _OnCard(dead))}[case]
    return lambda: elect_preferred(*args)


def _k4_case(ctx, case):
    from cruise_control_torch.kernels.apply_wave import apply_wave

    ts, ta = _on_card(ctx["ts"]), _on_card(ctx["ta"])
    n = 8
    i32 = torch.zeros(n, dtype=torch.int32)
    legs = [_OnCard(i32.clone()) for _ in range(4)]
    score, ok = _OnCard(torch.zeros(n)), _OnCard(torch.ones(n, dtype=torch.bool))
    if case == "dtype":
        legs[1] = _OnCard(i32.long())
    elif case == "shape":
        legs[3] = _OnCard(i32[1:])
    elif case == "rank":
        score = _OnCard(torch.zeros(n, 1))
    elif case == "device":
        ok = torch.ones(n, dtype=torch.bool)
    elif case == "other card":
        ta = ta._replace(broker_load=_OnCard(ctx["ta"].broker_load, "cuda:1"))
    else:
        ta = ta._replace(touch_tag=_OnCard(ctx["ta"].touch_tag.t().contiguous().t()))
    return lambda: apply_wave(ts, ta, *legs, score, ok, 3)


#: (kernel, case) -> (exception, message): the messages the wrappers gave
#: when they checked every argument one by one
REFUSALS = {
    ("K7", "dtype"): (TypeError, "leader_count: expected torch.int32, got torch.int64"),
    ("K7", "shape"): (ValueError, r"state_fingerprint: replica_count has shape \(23,\), "
                                  r"expected \(24,\)"),
    ("K7", "rank"): (ValueError, r"broker_load: expected rank 2, got shape \(96,\)"),
    ("K7", "device"): (ValueError, "leader_nw_in: expected a CUDA tensor, got cpu"),
    ("K7", "other card"): (ValueError, "leader_nw_in: on cuda:1, expected cuda:0"),
    ("K7", "contiguity"): (ValueError, "broker_load: must be contiguous"),
    ("K10", "dtype"): (TypeError, "batch.row: expected torch.int32, got torch.int64"),
    ("K10", "shape"): (ValueError, r"delta_scatter: topic_id has shape \(\d+,\), expected"),
    ("K10", "rank"): (ValueError, r"batch.load: expected rank 2, got shape \(\d+,\)"),
    ("K10", "device"): (ValueError, "broker_valid: expected a CUDA tensor, got cpu"),
    ("K10", "other card"): (ValueError, "batch.kind: on cuda:1, expected cuda:0"),
    ("K10", "contiguity"): (ValueError, "part_load: must be contiguous"),
    ("K11", "dtype"): (TypeError, "assignment: expected torch.int32, got torch.int64"),
    ("K11", "shape"): (ValueError, "elect_preferred: dead has 23 brokers, expected 24"),
    ("K11", "rank"): (ValueError, r"assignment: expected rank 2, got shape \(\d+,\)"),
    ("K11", "device"): (ValueError, "demoted: expected a CUDA tensor, got cpu"),
    ("K11", "other card"): (ValueError, "dead: on cuda:1, expected cuda:0"),
    ("K11", "contiguity"): (ValueError, "assignment: must be contiguous"),
    ("K4", "dtype"): (TypeError, "kind: expected torch.int32, got torch.int64"),
    ("K4", "shape"): (ValueError, "apply_wave: dst has 7 entries, score 8"),
    ("K4", "rank"): (ValueError, r"score: expected rank 1, got shape \(8, 1\)"),
    ("K4", "device"): (ValueError, "ok: expected a CUDA tensor, got cpu"),
    ("K4", "other card"): (ValueError, "apply_wave: context tensors must be contiguous and on "
                                       "cuda:0"),
    ("K4", "contiguity"): (ValueError, "apply_wave: context tensors must be contiguous and on "
                                      "cuda:0"),
}


@pytest.mark.parametrize("kernel,case", list(REFUSALS), ids=[" ".join(k) for k in REFUSALS])
def test_wrappers_refuse_what_their_kernels_do_not_take(ctx, kernel, case):
    """The reworked wrappers (one fast-path condition, the message built only
    on failure) refuse a wrong dtype, shape, rank, device, card or layout
    with the message each gave before, and launch nothing."""
    from cruise_control_torch import kernels

    call = {"K4": _k4_case, "K7": _k7_case, "K10": _k10_case, "K11": _k11_case}[kernel](ctx, case)
    exc, msg = REFUSALS[kernel, case]
    before = kernels.launches()
    with pytest.raises(exc, match=msg):
        call()
    assert kernels.launches() == before


@pytest.mark.parametrize("cut", [1, 5, 96])
def test_k7_plain_counts_positions_from_start(ctx, cut):
    """`_mix(x, salt, start)` of a slice starting at flat position `start`
    adds up, mod 2^32, to `_mix` of the whole: the card test past 2**31
    words sums its reference in such slices."""
    from cruise_control_torch.kernels.state_fingerprint import _mix

    flat = ctx["ta"].broker_load.reshape(-1)
    whole = int(_mix(flat, 0x9E3779B9))
    parts = int(_mix(flat[:cut], 0x9E3779B9)) + int(_mix(flat[cut:], 0x9E3779B9, start=cut))
    assert whole == parts & 0xFFFFFFFF
