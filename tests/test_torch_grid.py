"""The batch_k=1 greedy grid: the port's move grid, destination candidates,
K9's plain version and the bench's faithful-greedy solve (`GREEDY_SETTINGS`)
against the JAX package on the CPU.

- `make_move_batch` materialized through build_selected equals the JAX
  package's move batch, field by field.
- `dst_candidates` equals the jitted `_dst_candidates` (optimizer.py:303),
  with planted ties, an empty rack and a rack whose brokers are all
  excluded.
- `grid_shortlist_plain` equals a jitted JAX expression built, as
  optimizer.py:371-409 composes them, from the JAX package's own
  make_move_batch, score_batch, make_leadership_batch, jnp.argmax and
  lax.top_k: a hard goal with dead brokers, a count goal with leadership,
  the same goal without moves, planted ties and an all -inf grid. Integers
  exact, scores bit-equal.
- The greedy solve on fixture C (32 brokers, the bulk floor), fused
  (chunk 0) and through the chunked machine at chunk budgets 64 and 3,
  equals the JAX package's chunked run (whose fused run equals it, slow
  lane): final assignment, touch tags, proposals, the StackMetrics integers
  with the state fingerprints, the decision digest.

The JAX machine compiles once (its program ignores the chunk budget). No
assertion reads a clock.
"""

import copy
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import acceptance as jacc
from cruise_control_tpu.analyzer import actions as jact
from cruise_control_tpu.analyzer import context as jctx
from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.goals import goals_by_priority as jgoals
from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint
from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.analyzer import acceptance as tacc
from cruise_control_torch.analyzer import actions as tact
from cruise_control_torch.analyzer import context as tctx
from cruise_control_torch.analyzer import optimizer as topt
from cruise_control_torch.analyzer.goals import goals_by_priority as tgoals
from cruise_control_torch.config.balancing import BalancingConstraint as TConstraint
from cruise_control_torch.kernels.grid_shortlist import grid_shortlist, grid_shortlist_plain
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


FIXTURE_C = jgen.ClusterProperty(num_racks=4, num_brokers=32, num_topics=80,
                                 mean_partitions_per_topic=10, replication_factor=3,
                                 num_dead_brokers=2, load_distribution="pareto",
                                 mean_utilization=0.5)
GOAL_INDEX = {g.name: i for i, g in enumerate(jgoals(None))}
#: the JAX side of GREEDY_SETTINGS (bench.py:242-248 at its defaults, no
#: bucketing)
JAX_GREEDY = dict(batch_k=1, max_rounds_per_goal=512, num_dst_candidates=16, num_swap_pairs=16,
                  swap_candidates=16, swaps_per_broker=4, chunk_rounds=64,
                  cost_scaled_rounds=1.5, rounds_ceiling=4096, bucket_partitions=False,
                  bucket_brokers=False)
INT_METRICS = ("violated_before", "violated_after", "rounds", "converged", "state_fp")
CHUNKS = (0, 64, 3)


def _bits_equal(a, b):
    a = np.asarray(a)
    b_ = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if a.dtype == np.float32:
        return a.shape == b_.shape and np.array_equal(a.view(np.int32), b_.view(np.int32))
    return a.shape == b_.shape and np.array_equal(a, b_)


def _model():
    return jgen.random_cluster(42, FIXTURE_C)


@pytest.fixture(scope="module")
def ctx():
    m = _model()
    jd = jctx.dims_of(m)
    js = jctx.build_static_ctx(m, JConstraint.default(), jd)
    ja = jctx.compute_aggregates(js, m.assignment, jd)
    tm = from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})
    td = tctx.dims_of(tm)
    ts = tctx.build_static_ctx(tm, TConstraint.default(), td)
    ta = tctx.compute_aggregates(ts, tm.assignment, td)
    return dict(jd=jd, js=js, ja=ja, td=td, ts=ts, ta=ta)


def _setup(ctx, name, n_priors):
    gi = GOAL_INDEX[name]
    jg, tg = jgoals(None)[gi], tgoals(None)[gi]
    jt = jacc.build_tables(jgoals(None)[:n_priors], ctx["js"], ctx["ja"], ctx["jd"])
    tt = tacc.build_tables(tgoals(None)[:n_priors], ctx["ts"], ctx["ta"], ctx["td"])
    return jg, tg, jt, tt


def test_make_move_batch_equals_jax(ctx):
    cands = np.array([5, 0, 31, 17, 5], dtype=np.int32)
    jb = jact.make_move_batch(ctx["js"].part_load, ctx["ja"].assignment, jnp.asarray(cands))
    idx = tact.make_move_batch(ctx["ta"].assignment, torch.from_numpy(cands))
    assert [tuple(t.shape) for t in idx] == [(766, 1, 1), (), (1, 3, 1), (1, 1, 5)]
    tb = tact.build_selected(ctx["ts"].part_load, ctx["ta"].assignment, *idx)
    shape = (766, 3, 5)
    for f in jb._fields:
        j = np.broadcast_to(np.asarray(getattr(jb, f)), shape + np.shape(getattr(jb, f))[3:])
        t = getattr(tb, f).expand(j.shape)
        assert _bits_equal(j, t), f


class _JPref:
    """A goal stub whose destination preference is planted."""

    def __init__(self, pref):
        self.pref = pref

    def dst_preference(self, static, gs, agg):
        return jnp.asarray(self.pref)


class _TPref(_JPref):
    def dst_preference(self, static, gs, agg):
        return torch.from_numpy(self.pref)


def _planted_pref(num_brokers):
    rng = np.random.default_rng(7)
    # few distinct values: ties inside racks and across racks
    return rng.integers(0, 3, num_brokers).astype(np.float32)


@pytest.mark.parametrize("case", ["ties", "empty rack", "excluded rack", "tables"])
def test_dst_candidates_equal_jax(ctx, case):
    js, ts, ja, ta = ctx["js"], ctx["ts"], ctx["ja"], ctx["ta"]
    jd, td = ctx["jd"], ctx["td"]
    pref = _planted_pref(jd.num_brokers)
    jt = tt = None
    if case == "empty rack":
        # rack 2's brokers move to rack 1: rack 2 has no broker at all
        rack = np.asarray(js.broker_rack).copy()
        rack[rack == 2] = 1
        js = js._replace(broker_rack=jnp.asarray(rack))
        ts = ts._replace(broker_rack=torch.from_numpy(rack))
    elif case == "excluded rack":
        ok = np.asarray(js.replica_dst_ok).copy()
        ok[np.asarray(js.broker_rack) == 3] = False
        js = js._replace(replica_dst_ok=jnp.asarray(ok))
        ts = ts._replace(replica_dst_ok=torch.from_numpy(ok))
    elif case == "tables":
        _, _, jt, tt = _setup(ctx, "CpuCapacityGoal", 5)
    for k in (2, 4, 16):
        fn = jax.jit(partial(jopt._dst_candidates, goal=_JPref(pref), dims=jd, k=k))
        want = np.asarray(fn(js, None, ja, tables=jt))
        got = topt.dst_candidates(ts, None, ta, _TPref(pref), td, k, tt)
        assert got.dtype == torch.int32
        assert _bits_equal(want, got), (case, k, want, got)


def _jax_shortlist(static, agg, tables, goal, gs, dst_cands, dims, k_sel):
    """optimizer.py:371-409, composed from the JAX package's own functions."""
    p_count, r = dims.num_partitions, dims.max_rf
    kk = dst_cands.shape[0]
    best_score = jnp.full((p_count,), -jnp.inf)
    best_kind = jnp.zeros((p_count,), dtype=jnp.int32)
    best_slot = jnp.zeros((p_count,), dtype=jnp.int32)
    best_dst = jnp.zeros((p_count,), dtype=jnp.int32)
    if goal.uses_moves:
        mv = jact.make_move_batch(static.part_load, agg.assignment, dst_cands)
        s = jacc.score_batch(static, agg, mv, goal, gs, tables)
        s = jnp.broadcast_to(s, (p_count, r, kk)).reshape(p_count, r * kk)
        j = jnp.argmax(s, axis=1)
        best_score = jnp.take_along_axis(s, j[:, None], axis=1)[:, 0]
        best_kind = jnp.full((p_count,), jact.KIND_MOVE, dtype=jnp.int32)
        best_slot = (j // kk).astype(jnp.int32)
        best_dst = dst_cands[(j % kk).astype(jnp.int32)]
    if goal.uses_leadership and r >= 2:
        lb = jact.make_leadership_batch(static.part_load, agg.assignment)
        sl = jnp.broadcast_to(jacc.score_batch(static, agg, lb, goal, gs, tables), (p_count, r - 1))
        j2 = jnp.argmax(sl, axis=1)
        sbest = jnp.take_along_axis(sl, j2[:, None], axis=1)[:, 0]
        lead_slot = (j2 + 1).astype(jnp.int32)
        take = sbest > best_score
        best_score = jnp.maximum(best_score, sbest)
        best_kind = jnp.where(take, jact.KIND_LEADERSHIP, best_kind)
        best_slot = jnp.where(take, lead_slot, best_slot)
        rows = jnp.arange(p_count, dtype=jnp.int32)
        best_dst = jnp.where(take, agg.assignment[rows, lead_slot], best_dst)
    top_scores, top_p = jax.lax.top_k(best_score, k_sel)
    return (top_scores, top_p.astype(jnp.int32), best_kind[top_p], best_slot[top_p],
            best_dst[top_p], best_score)


SHORTLIST_CASES = {
    # goal, prior goals, k, variant
    "hard goal, dead brokers": ("DiskCapacityGoal", 2, 1, None),
    "count goal with leadership": ("LeaderReplicaDistributionGoal", 13, 1, None),
    "count goal without moves": ("LeaderReplicaDistributionGoal", 13, 1, "no moves"),
    "tied evacuations": ("ReplicaCapacityGoal", 1, 1, None),
    "tied evacuations, k = 4": ("ReplicaCapacityGoal", 1, 4, None),
    "all -inf": ("CpuCapacityGoal", 5, 1, "immovable"),
    "all -inf without moves": ("LeaderReplicaDistributionGoal", 13, 1, "immovable, no moves"),
}


@pytest.mark.parametrize("case", list(SHORTLIST_CASES))
def test_grid_shortlist_plain_equals_jax(ctx, case):
    name, n_priors, k, variant = SHORTLIST_CASES[case]
    jg, tg, jt, tt = _setup(ctx, name, n_priors)
    js, ts, ja, ta, jd, td = ctx["js"], ctx["ts"], ctx["ja"], ctx["ta"], ctx["jd"], ctx["td"]
    if variant and "no moves" in variant:
        jg, tg = copy.copy(jg), copy.copy(tg)
        jg.uses_moves = tg.uses_moves = False
    if variant and "immovable" in variant:
        js = js._replace(movable_partition=jnp.zeros_like(js.movable_partition))
        ts = ts._replace(movable_partition=torch.zeros_like(ts.movable_partition))
    jgs, tgs = jg.prepare(js, ja, jd), tg.prepare(ts, ta, td)
    k_dst = min(16, jd.num_racks)
    jc = jax.jit(partial(jopt._dst_candidates, goal=jg, dims=jd, k=k_dst))(js, jgs, ja, tables=jt)
    tc = topt.dst_candidates(ts, tgs, ta, tg, td, k_dst, tt)
    assert _bits_equal(jc, tc)
    want = jax.jit(partial(_jax_shortlist, goal=jg, dims=jd, k_sel=k))(js, ja, jt, gs=jgs,
                                                                       dst_cands=jc)
    got = grid_shortlist_plain(ts, ta, tt, tg, tgs, tc, k)
    # the CPU wrapper is the plain version
    assert all(torch.equal(a, b) for a, b in zip(got, grid_shortlist(ts, ta, tt, tg, tgs, tc, k)))
    for field, w, g in zip(("score", "p", "kind", "slot", "dst"), want[:5], got):
        assert _bits_equal(w, g), (case, field, np.asarray(w), g)
    best = np.asarray(want[5])
    finite = np.isfinite(best)
    if variant and "immovable" in variant:
        assert not finite.any()
    else:
        assert finite.any()
    if case.startswith("tied"):
        # the case is a tie: several partitions share the best score
        assert (best == best.max()).sum() > k


def _capturing(opt, attr="_run_chunked", module=None):
    """Wrap `opt._run_chunked` (or a module's `run_stack`) to keep what it
    returns: (agg, metrics, ...). Returns (seen, undo)."""
    seen = []
    owner = module if module is not None else opt
    inner = getattr(owner, attr)

    def run(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(out)
        return out

    setattr(owner, attr, run)
    return seen, lambda: setattr(owner, attr, inner)


def port_run(settings, model, goal_names=None):
    """(result, host StackMetrics) of the port's CPU run, fused or chunked."""
    tmodel = from_numpy({k: np.asarray(v) for k, v in model._asdict().items()})
    opt = topt.GoalOptimizer(settings=settings, device="cpu")
    fused = settings.chunk_rounds == 0
    seen, undo = _capturing(opt, "run_stack", topt) if fused else _capturing(opt)
    try:
        res = opt.optimizations(tmodel, goal_names, raise_on_hard_failure=False)
    finally:
        undo()
    return res, seen[0][1]


def jax_run(settings, model, goal_names=None):
    """(result, metrics, touch tags) of the JAX package's run, fused or
    chunked (the fused program runs a second time for its metrics)."""
    jo = jopt.GoalOptimizer(settings=settings)
    seen, _ = _capturing(jo)
    jres = jo.optimizations(model, goal_names, raise_on_hard_failure=False)
    if settings.chunk_rounds:
        jagg, jm = seen[0][0], seen[0][1]
    else:
        goals, _, _, dims, static, agg, _ = jo._prepare(model, goal_names,
                                                       jopt.OptimizationOptions())
        step = jopt._stack_executable(tuple(g.name for g in goals), dims, settings, None,
                                      static, agg)
        jagg, jm, _ = step(static, agg)
    return jres, jax.device_get(jm), np.asarray(jax.device_get(jagg.touch_tag))


@pytest.fixture(scope="module")
def greedy_runs():
    """{chunk: (jax result, jax metrics, jax touch tags, port result, port
    metrics)} at chunk budgets 0 (the port's fused stack), 64 and 3, each
    against the JAX package's chunked run (its program ignores the budget;
    its fused run equals it, and that comparison is in the slow lane)."""
    out = {}
    model = _model()
    jax_chunked = jax_run(jopt.OptimizerSettings(**JAX_GREEDY), model)
    for chunk in CHUNKS:
        if chunk not in (0, JAX_GREEDY["chunk_rounds"]):
            jres = jax_run(jopt.OptimizerSettings(**dict(JAX_GREEDY, chunk_rounds=chunk)), model)
        else:
            jres = jax_chunked
        tres, tm = port_run(dataclasses.replace(topt.GREEDY_SETTINGS, chunk_rounds=chunk), model)
        out[chunk] = jres + (tres, tm)
    return out


@pytest.mark.slow
def test_greedy_fused_run_equals_jax_fused_run():
    """The JAX package's fused greedy program (every goal traced into one
    program) against the port's fused run."""
    model = _model()
    jres, jm, jtouch = jax_run(jopt.OptimizerSettings(**dict(JAX_GREEDY, chunk_rounds=0)), model)
    tres, tm = port_run(dataclasses.replace(topt.GREEDY_SETTINGS, chunk_rounds=0), model)
    assert np.array_equal(np.asarray(jres.final_assignment), tres.final_assignment)
    assert np.array_equal(jtouch, tres.touch_tag)
    for field in INT_METRICS:
        assert np.array_equal(np.asarray(getattr(jm, field)).astype(np.int64),
                              np.asarray(getattr(tm, field)).astype(np.int64)), field
    names = [g.name for g in tres.goal_results]
    assert tres.provenance.digest(goals=names) == jres.provenance.digest(goals=names)


def test_greedy_settings_are_the_bench_greedy_pass():
    s = topt.GREEDY_SETTINGS
    for k, v in JAX_GREEDY.items():
        assert getattr(s, k) == v, k
    j = jopt.OptimizerSettings(**JAX_GREEDY)
    for f in dataclasses.fields(s):
        if f.name not in JAX_GREEDY:
            assert getattr(s, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("chunk", CHUNKS)
def test_greedy_final_assignment_and_touch_tags_equal_jax(greedy_runs, chunk):
    jres, _, jtouch, tres, _ = greedy_runs[chunk]
    assert np.array_equal(np.asarray(jres.final_assignment), tres.final_assignment)
    assert np.array_equal(jtouch, tres.touch_tag)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_greedy_proposals_equal_jax(greedy_runs, chunk):
    jres, _, _, tres, _ = greedy_runs[chunk]
    assert tres.num_replica_moves > 0

    def key(prs):
        return [(p.partition, p.old_replicas, p.new_replicas, p.data_to_move_mb) for p in prs]

    assert key(jres.proposals) == key(tres.proposals)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_greedy_stack_metrics_integers_equal_jax(greedy_runs, chunk):
    _, jm, _, _, tm = greedy_runs[chunk]
    for field in INT_METRICS:
        assert np.array_equal(np.asarray(getattr(jm, field)).astype(np.int64),
                              np.asarray(getattr(tm, field)).astype(np.int64)), field
    np.testing.assert_allclose(tm.cost_after, np.asarray(jm.cost_after), rtol=1e-5)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_greedy_decision_digest_equals_jax(greedy_runs, chunk):
    jres, _, _, tres, _ = greedy_runs[chunk]
    names = [g.name for g in tres.goal_results]
    assert tres.provenance.digest(goals=names) == jres.provenance.digest(goals=names)
    engines = {s.goal: s.engine for s in tres.provenance.segments}
    assert engines["RackAwareGoal"] == "grid" and engines["DiskUsageDistributionGoal"] == "drain"


def _jax_scaled_cap(cost, violated, floor, use_bulk, settings):
    """optimizer.py:646-667 on one goal's entry cost and violated count."""
    scale = cost
    if use_bulk:
        scale = scale / jnp.maximum(1.0, violated.astype(jnp.float32))
    scaled = jnp.clip(jnp.ceil(settings.cost_scaled_rounds * scale), jnp.float32(floor),
                      jnp.float32(settings.rounds_ceiling))
    return scaled.astype(jnp.int32)


@pytest.mark.parametrize("use_bulk", [False, True])
def test_cost_scaled_caps_equal_jax(use_bulk):
    """The float32 cap arithmetic: costs near whole multiples, byte-sized
    costs past int32, and violated counts 0..n, against jitted JAX."""
    rng = np.random.default_rng(3)
    costs = np.concatenate([
        np.float32(np.arange(1, 400)) / np.float32(1.5), np.float32(np.arange(1, 400)) / 3,
        rng.uniform(0, 5000, 500), rng.uniform(0, 5e12, 50), [0.0, 1e-7, 2730.6667, 4e9],
    ]).astype(np.float32)
    violated = rng.integers(0, 40, costs.shape[0]).astype(np.int32)
    settings = jopt.OptimizerSettings(**JAX_GREEDY)
    fn = jax.jit(partial(_jax_scaled_cap, floor=512, use_bulk=use_bulk, settings=settings))
    want = np.asarray(jax.vmap(fn)(jnp.asarray(costs), jnp.asarray(violated)))
    got = [topt._scaled_cap(torch.tensor(c), torch.tensor(v), use_bulk, 512, topt.GREEDY_SETTINGS)
           for c, v in zip(costs, violated)]
    assert np.array_equal(want, np.asarray(got))
    assert want.min() == 512 and want.max() == 4096 and len(set(want.tolist())) > 50
