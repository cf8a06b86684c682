"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and the CUDA toolkit; without one each skips.
They import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest`: the suite's conftest configures JAX.) The inputs are a small
seeded cluster; the full-size comparison is chip_smoke.py's. Besides seeded
inputs, every kernel is replayed on the calls the 15-goal stack made on the
CPU (the plain versions) on a 32-broker cluster, and the stack itself is run
on the card and held equal to the CPU run.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_torch.analyzer import optimizer as opt
from cruise_control_torch.analyzer.acceptance import build_tables
from cruise_control_torch.analyzer.actions import KIND_MOVE, leadership_grid
from cruise_control_torch.analyzer.context import build_static_ctx, compute_aggregates, dims_of
from cruise_control_torch.analyzer.goals import HARD_GOAL_NAMES, goals_by_priority
from cruise_control_torch.config.balancing import BalancingConstraint
from cruise_control_torch.kernels.apply_wave import apply_wave, apply_wave_plain
from cruise_control_torch.kernels.broker_topk import broker_topk, broker_topk_plain
from cruise_control_torch.kernels.pair_picks import pair_picks, pair_picks_plain
from cruise_control_torch.kernels.score_candidates import score_candidates, score_candidates_plain
from cruise_control_torch.analyzer.stats import compute_stats
from cruise_control_torch.kernels.cluster_stats import cluster_stats, cluster_stats_plain
from cruise_control_torch.kernels.state_fingerprint import (
    state_fingerprint,
    state_fingerprint_plain,
)
from cruise_control_torch.kernels.window_sum import window_sum, window_sum_plain
from cruise_control_torch.models import generators

pytestmark = pytest.mark.cuda

PROP = generators.ClusterProperty(num_racks=4, num_brokers=24, num_topics=60,
                                  mean_partitions_per_topic=10.0, replication_factor=3,
                                  num_dead_brokers=2, load_distribution="pareto",
                                  mean_utilization=0.5)


@pytest.fixture(scope="module")
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    cpu = generators.random_cluster(42, PROP)
    a = cpu.assignment.clone()
    a[::9, 2] = -1
    cpu = cpu._replace(assignment=a, broker_host=torch.arange(24, dtype=torch.int32) // 2)
    gpu = cpu.to("cuda")
    dims = dims_of(cpu)
    c = dataclasses.replace(BalancingConstraint.default(), max_replicas_per_broker=80)
    sc, sg = build_static_ctx(cpu, c, dims), build_static_ctx(gpu, c, dims)
    return dict(dims=dims, sc=sc, sg=sg, ac=compute_aggregates(sc, cpu.assignment, dims),
                ag=compute_aggregates(sg, gpu.assignment, dims))


def _bits(x, y):
    x, y = x.cpu().contiguous(), y.cpu().contiguous()
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return x.shape == y.shape and torch.equal(x, y)


def test_k1_segment_aggregates(pair):
    for f in pair["ac"]._fields:
        assert _bits(pair["ac"]._asdict()[f], pair["ag"]._asdict()[f]), f


@pytest.mark.parametrize("heaviest", [True, False])
def test_k2_broker_topk(pair, heaviest):
    rng = np.random.default_rng(1)
    shape = pair["ac"].assignment.shape
    c = torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    c[torch.from_numpy(rng.random(shape) < 0.05)] = -torch.inf
    c[c == 0] = -0.0
    out_c = broker_topk_plain(c, pair["ac"].assignment, pair["sc"].movable_partition, 8, 24,
                              heaviest)
    out_g = broker_topk(c.cuda(), pair["ag"].assignment, pair["sg"].movable_partition, 8, 24,
                        heaviest)
    for x, y in zip(out_c, out_g):
        assert _bits(x, y)


STACK_IDS = [g.name for g in goals_by_priority(None)]


@pytest.mark.parametrize("gi", range(15), ids=STACK_IDS)
def test_k3_score_candidates(pair, gi):
    goals = goals_by_priority(None)
    rng = np.random.default_rng(gi)
    p = torch.from_numpy(rng.integers(0, pair["dims"].num_partitions, (16, 4, 1)).astype(np.int32))
    s = torch.from_numpy(rng.integers(0, 3, (16, 4, 1)).astype(np.int32))
    d = torch.from_numpy(rng.permutation(24)[:12].astype(np.int32)).reshape(1, 1, 12)
    for side in ("c", "g"):
        pair["t" + side] = build_tables(goals[:gi], pair["s" + side], pair["a" + side], pair["dims"])
    g = goals[gi]
    gsc = g.prepare(pair["sc"], pair["ac"], pair["dims"])
    gsg = g.prepare(pair["sg"], pair["ag"], pair["dims"])
    kind = torch.tensor(KIND_MOVE, dtype=torch.int32)
    grids = [((p, kind, s, d), (p.cuda(), kind.cuda(), s.cuda(), d.cuda())),
             (leadership_grid(pair["ac"].assignment), leadership_grid(pair["ag"].assignment))]
    for idx_c, idx_g in grids:
        sc_ = score_candidates_plain(pair["sc"], pair["ac"], pair["tc"], g, gsc, *idx_c)
        sg_ = score_candidates(pair["sg"], pair["ag"], pair["tg"], g, gsg, *idx_g).cpu()
        fin = torch.isfinite(sc_)
        assert torch.equal(fin, torch.isfinite(sg_))
        assert _bits(sc_[fin], sg_[fin])


def test_k4_apply_wave(pair):
    rng = np.random.default_rng(5)
    a = pair["ac"].assignment
    n = 256
    p = torch.from_numpy(rng.integers(0, a.shape[0], n).astype(np.int32))
    kind = torch.from_numpy((rng.random(n) < 0.4).astype(np.int32))
    slot = torch.where(kind == 1, torch.from_numpy(rng.integers(1, 3, n)),
                       torch.from_numpy(rng.integers(0, 3, n))).to(torch.int32)
    dst = torch.where(kind == 1, a[p.long(), slot.long()],
                      torch.from_numpy(rng.integers(0, 24, n).astype(np.int32)))
    score = torch.from_numpy(rng.integers(0, 4, n).astype(np.float32))
    src = torch.where(kind == 0, a[p.long(), slot.long()], a[p.long(), 0])
    ok = (src >= 0) & (dst >= 0) & (src != dst) & torch.from_numpy(rng.random(n) < 0.8)
    ac = type(pair["ac"])(*(t.clone() for t in pair["ac"]))
    ag = type(pair["ag"])(*(t.clone() for t in pair["ag"]))
    sel_c = apply_wave_plain(pair["sc"], ac, p, kind, slot, dst, score, ok, 5)
    sel_g = apply_wave(pair["sg"], ag, p.cuda(), kind.cuda(), slot.cuda(), dst.cuda(),
                       score.cuda(), ok.cuda(), 5)
    assert _bits(sel_c, sel_g) and int(sel_c.sum()) > 0
    for f in ac._fields:
        assert _bits(ac._asdict()[f], ag._asdict()[f]), f


def test_slice_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    model = generators.random_cluster(42, PROP)
    res = [opt.GoalOptimizer(device=d).optimizations(model, HARD_GOAL_NAMES,
                                                     raise_on_hard_failure=False)
           for d in ("cpu", "cuda")]
    assert np.array_equal(res[0].final_assignment, res[1].final_assignment)
    assert np.array_equal(res[0].touch_tag, res[1].touch_tag)
    for a, b in zip(res[0].goal_results, res[1].goal_results):
        assert (a.violated_brokers_after, a.rounds, a.converged) == (
            b.violated_brokers_after, b.rounds, b.converged)


@pytest.mark.parametrize("legs", [1, 2, 3])
def test_k4_apply_wave_large_and_two_legs(pair, legs):
    """3,000 single actions (several entries per thread), random swaps, and
    random relays (a third broker claimed): selection and aggregates exact."""
    rng = np.random.default_rng(7 + legs)
    a = pair["ac"].assignment
    n = 3000 if legs == 1 else 700

    def leg(kind_prob):
        p = torch.from_numpy(rng.integers(0, a.shape[0], n).astype(np.int32))
        kind = torch.from_numpy((rng.random(n) < kind_prob).astype(np.int32))
        slot = torch.where(kind == 1, torch.from_numpy(rng.integers(1, 3, n)),
                           torch.from_numpy(rng.integers(0, 3, n))).to(torch.int32)
        dst = torch.where(kind == 1, a[p.long(), slot.long()],
                          torch.from_numpy(rng.integers(0, 24, n).astype(np.int32)))
        return p, kind, slot, dst

    p, kind, slot, dst = leg(0.0 if legs == 2 else (1.0 if legs == 3 else 0.4))
    leg2 = None
    if legs > 1:
        # as in every swap and relay, leg 2 leaves the broker leg 1 enters:
        # a swap moves a replica of dst back to leg 1's source, a relay
        # promotes a follower of a partition that dst leads
        an = a.numpy()
        p2, s2 = np.zeros(n, np.int32), np.zeros(n, np.int32)
        for i, d in enumerate(dst.tolist()):
            held = np.argwhere(an == d) if legs == 2 else np.argwhere(an[:, :1] == d)
            p2[i] = held[rng.integers(0, len(held))][0] if len(held) else 0
            s2[i] = (held[rng.integers(0, len(held))][1] if legs == 2 and len(held)
                     else rng.integers(1, 3))
        p2, s2 = torch.from_numpy(p2), torch.from_numpy(s2)
        if legs == 2:
            kind2 = torch.zeros(n, dtype=torch.int32)
            dst2 = a[p.long(), slot.long()]
        else:
            kind2 = torch.ones(n, dtype=torch.int32)
            dst2 = a[p2.long(), s2.long()]
        leg2 = (p2, kind2, s2, dst2)
    score = torch.from_numpy(rng.integers(0, 6, n).astype(np.float32))
    ok = torch.from_numpy(rng.random(n) < 0.8)
    # the scoring kernels flag valid actions only
    for q, kd, sl, ds in [(p, kind, slot, dst)] + ([leg2] if leg2 else []):
        src = torch.where(kd == 0, a[q.long(), sl.long()], a[q.long(), 0])
        ok &= (src >= 0) & (ds >= 0) & (src != ds)
    if leg2 is not None:
        src2 = torch.where(leg2[1] == 0, a[leg2[0].long(), leg2[2].long()], a[leg2[0].long(), 0])
        ok &= (src2 == dst) & (leg2[0] != p)
    ac = type(pair["ac"])(*(t.clone() for t in pair["ac"]))
    ag = type(pair["ag"])(*(t.clone() for t in pair["ag"]))
    sel_c = apply_wave_plain(pair["sc"], ac, p, kind, slot, dst, score, ok, 9, leg2, legs == 3)
    sel_g = apply_wave(pair["sg"], ag, p.cuda(), kind.cuda(), slot.cuda(), dst.cuda(),
                       score.cuda(), ok.cuda(), 9,
                       None if leg2 is None else tuple(t.cuda() for t in leg2), legs == 3)
    assert _bits(sel_c, sel_g) and int(sel_c.sum()) > 0
    for f in ac._fields:
        assert _bits(ac._asdict()[f], ag._asdict()[f]), f


def test_k6_pair_picks(pair):
    rng = np.random.default_rng(3)
    a = pair["ac"].assignment
    pair_b = torch.from_numpy(rng.permutation(24)[:10].astype(np.int32))
    topic = pair["sc"].topic_id
    # half the pairs name a topic their broker holds, half any topic
    held = [int(topic[int(np.argwhere(a.numpy() == b)[0][0])]) for b in pair_b[:5].tolist()]
    pair_t = torch.tensor(held + list(rng.integers(0, 60, 5)), dtype=torch.int32)
    for k in (2, 4, 40):
        out_c = pair_picks_plain(a, topic, pair["sc"].movable_partition, pair_t, pair_b, k, 24)
        out_g = pair_picks(pair["ag"].assignment, pair["sg"].topic_id,
                           pair["sg"].movable_partition, pair_t.cuda(), pair_b.cuda(), k, 24)
        for x, y in zip(out_c, out_g):
            assert _bits(x, y)
        assert bool(out_c[2].any()) and not bool(out_c[2].all())


def test_window_sum_is_sequential():
    # sequential within each window of 32, then over the window sums
    # (XLA:CPU's order): bit-equal to the plain version at every length
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(2)
    for shape in ((2600,), (32,), (2600, 4), (1,), (33,), (199518,), (1025, 3), (2600, 1100)):
        x = rng.standard_normal(shape).astype(np.float32) * np.float32(1e3)
        want = window_sum_plain(torch.from_numpy(x))
        got = window_sum(torch.from_numpy(x).cuda())
        assert _bits(want, got), shape
    z = torch.full((100,), -0.0)
    assert _bits(window_sum_plain(z), window_sum(z.cuda()))


def test_k7_state_fingerprint(pair):
    assert int(state_fingerprint_plain(pair["ac"])) == int(state_fingerprint(pair["ag"]))
    flipped = pair["ag"]._replace(broker_load=pair["ag"].broker_load.clone())
    flipped.broker_load[3, 1] = -flipped.broker_load[3, 1]
    plain = state_fingerprint_plain(pair["ac"]._replace(broker_load=flipped.broker_load.cpu()))
    assert int(plain) == int(state_fingerprint(flipped)) != int(state_fingerprint(pair["ag"]))


@pytest.mark.parametrize("dead_all", [False, True])
def test_k8_cluster_stats(pair, dead_all):
    ac, ag = pair["ac"], pair["ag"]
    alive = pair["sc"].alive & (not dead_all)
    args_c = (ac.broker_load, pair["sc"].broker_capacity, alive, ac.replica_count,
              ac.leader_count, ac.potential_nw_out, ac.topic_replica_count)
    out_c = cluster_stats_plain(*args_c)
    out_g = cluster_stats(*(t.cuda() for t in args_c))
    torch.cuda.synchronize()
    for x, y in zip(out_c, out_g):
        assert _bits(x, y)


def test_compute_stats_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    model = generators.random_cluster(42, FIXTURE_C)
    t = model.num_topics
    c, g = compute_stats(model, t), compute_stats(model.to("cuda"), t)
    for x, y in zip(c, g):
        assert _bits(x, y)


# -- replay of the 15-goal stack's kernel calls -------------------------------------

FIXTURE_C = generators.ClusterProperty(num_racks=4, num_brokers=32, num_topics=80,
                                       mean_partitions_per_topic=10, replication_factor=3,
                                       num_dead_brokers=2, load_distribution="pareto",
                                       mean_utilization=0.5)


def _map(x, fn):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(v, fn) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    return x


@pytest.fixture(scope="module")
def recorded():
    """The first calls of each kernel variant in the CPU stack run: (name,
    args, kwargs, output, args after the call)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from cruise_control_torch.analyzer import bulk, drain, goals, swaps

    calls, seen = [], collections.Counter()

    def variant(name, args, kw):
        if name == "score_swaps":
            return (name, int(args[0]), kw.get("wave", False))
        if name == "apply_wave":
            return (name, kw.get("leg2") is not None, kw.get("brokers3", False))
        if name == "score_candidates":
            return (name, args[3].name)
        return (name,)

    def wrap(name, fn):
        def call(*args, **kw):
            key = variant(name, args, kw)
            keep = seen[key] < 3
            before = _map((args, kw), lambda t: t.clone()) if keep else None
            out = fn(*args, **kw)
            if keep:
                seen[key] += 1
                calls.append((name, before[0], before[1], _map(out, lambda t: t.clone()),
                              _map(args, lambda t: t.clone())))
            return out
        return call

    targets = [(drain, "score_swaps"), (swaps, "score_swaps"), (drain, "apply_wave"),
               (bulk, "apply_wave"), (swaps, "apply_wave"), (drain, "score_candidates"),
               (bulk, "score_candidates"), (drain, "pair_picks"), (goals.soft, "window_sum"),
               (drain, "broker_topk"), (bulk, "broker_topk")]
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in targets:
            mp.setattr(mod, name, wrap(name, getattr(mod, name)))
        model = generators.random_cluster(42, FIXTURE_C)
        opt.GoalOptimizer(settings=opt.STACK_SETTINGS, device="cpu").optimizations(
            model, None, raise_on_hard_failure=False)
    return calls


def test_stack_kernel_calls_replay_on_the_card(recorded):
    from cruise_control_torch import kernels

    wrappers = kernels.wrappers()
    kinds = collections.Counter(name for name, *_ in recorded)
    for name in ("score_swaps", "apply_wave", "score_candidates", "pair_picks", "window_sum",
                 "broker_topk"):
        assert kinds[name] > 0, name
    for name, args, kw, out_c, after_c in recorded:
        args_g, kw_g = _map(args, lambda t: t.cuda()), _map(kw, lambda t: t.cuda())
        out_g = wrappers[name](*args_g, **kw_g)
        torch.cuda.synchronize()
        flat_c, flat_g = [], []
        _map(out_c, flat_c.append)
        _map(out_g, flat_g.append)
        if name == "apply_wave":  # the aggregates it wrote in place
            _map(after_c[1], flat_c.append)
            _map(args_g[1], flat_g.append)
        assert len(flat_c) == len(flat_g)
        for x, y in zip(flat_c, flat_g):
            assert _bits(x, y), name


def test_stack_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    model = generators.random_cluster(42, FIXTURE_C)
    res = [opt.GoalOptimizer(settings=opt.STACK_SETTINGS, device=d).optimizations(
        model, None, raise_on_hard_failure=False) for d in ("cpu", "cuda")]
    assert np.array_equal(res[0].final_assignment, res[1].final_assignment)
    assert np.array_equal(res[0].touch_tag, res[1].touch_tag)
    for a, b in zip(res[0].goal_results, res[1].goal_results):
        assert (a.violated_brokers_after, a.rounds, a.converged, a.cost_after) == (
            b.violated_brokers_after, b.rounds, b.converged, b.cost_after)


def test_service_on_the_card_equals_the_cpu():
    """The chunked goal machine with the ledger and the statistics
    (SERVICE_SETTINGS, chunk budget 3 so that goals pause and resume) on the
    card against the CPU, and against the fused run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from cruise_control_torch import kernels
    from cruise_control_torch.analyzer.stats import stats_to_dict

    model = generators.random_cluster(42, FIXTURE_C)
    settings = dataclasses.replace(opt.SERVICE_SETTINGS, chunk_rounds=3)
    kernels.reset_launches()
    res = [opt.GoalOptimizer(settings=settings, device=d).optimizations(
        model, None, raise_on_hard_failure=False) for d in ("cpu", "cuda")]
    launched = kernels.launches()
    assert launched["state_fingerprint"] > 0 and launched["cluster_stats"] == 2
    fused = opt.GoalOptimizer(settings=dataclasses.replace(opt.STACK_SETTINGS, ledger=True),
                              device="cuda").optimizations(model, None,
                                                           raise_on_hard_failure=False)
    names = [g.name for g in fused.goal_results]
    for r in (res[1], fused):
        assert np.array_equal(res[0].final_assignment, r.final_assignment)
        assert np.array_equal(res[0].touch_tag, r.touch_tag)
        assert res[0].provenance.digest(goals=names) == r.provenance.digest(goals=names)
    assert stats_to_dict(res[0].stats_after) == stats_to_dict(res[1].stats_after)
    assert stats_to_dict(res[0].stats_before) == stats_to_dict(res[1].stats_before)


@pytest.mark.parametrize("gi", range(15), ids=STACK_IDS)
@pytest.mark.parametrize("variant", ["grid", "no moves", "immovable"])
def test_k9_grid_shortlist(pair, gi, variant):
    """K9 against its plain version on every goal's grid under its priors'
    tables, toward 4 rack-representative destinations: the same goal
    without moves, and an all -inf grid (nothing movable)."""
    import copy

    from cruise_control_torch.kernels.grid_shortlist import grid_shortlist, grid_shortlist_plain

    goals = goals_by_priority(None)
    g = goals[gi]
    if variant == "no moves":
        g = copy.copy(g)
        g.uses_moves = False
    sc, sg = pair["sc"], pair["sg"]
    if variant == "immovable":
        sc = sc._replace(movable_partition=torch.zeros_like(sc.movable_partition))
        sg = sg._replace(movable_partition=torch.zeros_like(sg.movable_partition))
    tc = build_tables(goals[:gi], sc, pair["ac"], pair["dims"])
    tg = build_tables(goals[:gi], sg, pair["ag"], pair["dims"])
    gsc = g.prepare(sc, pair["ac"], pair["dims"])
    gsg = g.prepare(sg, pair["ag"], pair["dims"])
    cands = opt.dst_candidates(sc, gsc, pair["ac"], g, pair["dims"], 4, tc)
    assert torch.equal(cands, opt.dst_candidates(sg, gsg, pair["ag"], g, pair["dims"], 4,
                                                 tg).cpu())
    want = grid_shortlist_plain(sc, pair["ac"], tc, g, gsc, cands)
    got = grid_shortlist(sg, pair["ag"], tg, g, gsg, cands.cuda())
    for w, x in zip(want, got):
        assert _bits(w, x), (variant, want, got)
    if variant == "immovable":
        assert not torch.isfinite(want[0]).any()


def test_greedy_and_polish_on_the_card_equal_the_cpu():
    """The bench's greedy pass (GREEDY_SETTINGS, chunk budgets 64 and 3) and
    its batched pass with 8 polish rounds (chunk budget 3, and fused) on the
    card against the CPU: assignment, touch tags, goal rows, digest. The
    greedy solve launches K9; the polish pass compares K7's fingerprints."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from cruise_control_torch import kernels

    model = generators.random_cluster(42, FIXTURE_C)
    polish = dataclasses.replace(opt.BENCH_SETTINGS, polish_rounds=8)
    for settings in (opt.GREEDY_SETTINGS, dataclasses.replace(opt.GREEDY_SETTINGS, chunk_rounds=3),
                     dataclasses.replace(polish, chunk_rounds=3),
                     dataclasses.replace(polish, chunk_rounds=0)):
        kernels.reset_launches()
        res = [opt.GoalOptimizer(settings=settings, device=d).optimizations(
            model, None, raise_on_hard_failure=False) for d in ("cpu", "cuda")]
        launched = kernels.launches()
        if settings.batch_k == 1:
            assert launched["grid_shortlist"] > 0
        else:
            assert launched["state_fingerprint"] > 30
        names = [g.name for g in res[0].goal_results]
        assert np.array_equal(res[0].final_assignment, res[1].final_assignment)
        assert np.array_equal(res[0].touch_tag, res[1].touch_tag)
        assert res[0].provenance.digest(goals=names) == res[1].provenance.digest(goals=names)
        for a, b in zip(res[0].goal_results, res[1].goal_results):
            assert (a.violated_brokers_after, a.rounds, a.converged, a.cost_after) == (
                b.violated_brokers_after, b.rounds, b.converged, b.cost_after)
