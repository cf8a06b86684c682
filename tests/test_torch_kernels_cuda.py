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

import merge_cases
import numpy as np
import pytest
import topk_cases
import torch
import wave_cases

from cruise_control_torch.analyzer import optimizer as opt
from cruise_control_torch.analyzer.acceptance import build_tables
from cruise_control_torch.analyzer.actions import KIND_LEADERSHIP, KIND_MOVE, leadership_grid
from cruise_control_torch.analyzer.context import build_static_ctx, compute_aggregates, dims_of
from cruise_control_torch.analyzer.goals import HARD_GOAL_NAMES, goals_by_priority
from cruise_control_torch.config.balancing import BalancingConstraint
from cruise_control_torch.kernels import apply_wave as k4
from cruise_control_torch.kernels import window_sum as ws
from cruise_control_torch.kernels.apply_wave import apply_wave, apply_wave_plain
from cruise_control_torch.kernels.broker_topk import broker_topk, broker_topk_plain
from cruise_control_torch.kernels.pair_picks import pair_picks, pair_picks_plain
from cruise_control_torch.kernels import score_candidates as k3_module
from cruise_control_torch.kernels.score_candidates import score_candidates, score_candidates_plain
from cruise_control_torch.analyzer.stats import compute_stats
from cruise_control_torch.kernels.cluster_stats import cluster_stats, cluster_stats_plain
from cruise_control_torch.kernels.state_fingerprint import (
    state_fingerprint,
    state_fingerprint_plain,
)
from cruise_control_torch.kernels.window_sum import window_sum, window_sum_plain
from cruise_control_torch.models import generators
from cruise_control_torch.models.flat_model import from_numpy

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


@pytest.fixture(scope="module")
def waves():
    """tests/wave_cases.py's cluster (three brokers a host) on both sides,
    and its crafted K4 waves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    arrays = wave_cases.cluster_arrays()
    cpu = from_numpy(arrays)
    gpu = cpu.to("cuda")
    dims = dims_of(cpu)
    sc = build_static_ctx(cpu, BalancingConstraint.default(), dims)
    sg = build_static_ctx(gpu, BalancingConstraint.default(), dims)
    ac = compute_aggregates(sc, cpu.assignment, dims)
    return dict(arrays=arrays, sc=sc, sg=sg, ac=ac, ag=compute_aggregates(sg, gpu.assignment, dims),
                cases=wave_cases.cases(arrays, ac.host_cpu_load.numpy()))


def _k4_both(sc, sg, ac, ag, w, tag=5):
    """Apply wave `w` (a wave_cases dict) with the plain version to `ac` and
    with the kernel to `ag`, in place; the two selections."""
    legs = [tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in leg) for leg in w["legs"]]
    score, ok = torch.from_numpy(w["score"]), torch.from_numpy(w["ok"])
    sel_c = apply_wave_plain(sc, ac, *legs[0], score, ok, tag,
                             legs[1] if len(legs) > 1 else None, w["brokers3"])
    gl = [tuple(t.cuda() for t in leg) for leg in legs]
    sel_g = apply_wave(sg, ag, *gl[0], score.cuda(), ok.cuda(), tag,
                       gl[1] if len(gl) > 1 else None, w["brokers3"])
    torch.cuda.synchronize()
    return sel_c, sel_g


def _fresh(agg):
    return type(agg)(*(t.clone() for t in agg))


def _workspace_at_sentinels():
    ws = k4._WORKSPACE[torch.device("cuda", torch.cuda.current_device())]
    return bool((ws[0] == 0).all()) and bool((ws[1] == torch.iinfo(torch.int32).max).all())


@pytest.mark.parametrize("case", ["not_a_candidate", "signed_zeros", "shared_source_hosts",
                                  "relays_e_is_b", "bulk_width"])
def test_k4_crafted_waves(waves, case):
    """tests/test_torch_wave_select.py's waves, which the CPU tests hold the
    plain version to JAX on: the kernel's selection and every aggregate
    bit-equal to the plain version's, and the case occurs."""
    w = waves["cases"][case]
    ac, ag = _fresh(waves["ac"]), _fresh(waves["ag"])
    before = k4.apply_wave.launches
    sel_c, sel_g = _k4_both(waves["sc"], waves["sg"], ac, ag, w)
    assert k4.apply_wave.launches == before + 1
    assert _bits(sel_c, sel_g) and w["occurs"](sel_c.numpy())
    for f in ac._fields:
        assert _bits(ac._asdict()[f], ag._asdict()[f]), f
    assert _workspace_at_sentinels()


@pytest.mark.parametrize("legs", [1, 2])
def test_k4_wave_of_4096_entries(waves, legs):
    """The most entries a wave may hold, over 24 brokers (heavy conflicts,
    four entries a thread): random moves and promotions, or relays."""
    rng = np.random.default_rng(40 + legs)
    a = waves["arrays"]["assignment"]
    n, b = k4.BLOCK_ENTRIES, wave_cases.NUM_BROKERS
    p = rng.integers(0, a.shape[0], n).astype(np.int32)
    if legs == 1:
        kind = (rng.random(n) < 0.4).astype(np.int32)
        slot = np.where(kind == 1, rng.integers(1, 3, n), rng.integers(0, 3, n)).astype(np.int32)
        dst = np.where(kind == 1, a[p, slot], rng.integers(0, b, n)).astype(np.int32)
        wave_legs = [(p, kind, slot, dst)]
    else:
        # relays: leg 2 promotes a follower of a partition that d leads
        lead = np.ones(n, np.int32)
        s1 = rng.integers(1, 3, n).astype(np.int32)
        d = a[p, s1]
        led = [np.nonzero(a[:, 0] == x)[0] for x in range(b)]
        p2 = np.asarray([led[x][rng.integers(0, len(led[x]))] if x >= 0 and len(led[x]) else 0
                         for x in d], dtype=np.int32)
        s2 = rng.integers(1, 3, n).astype(np.int32)
        wave_legs = [(p, lead, s1, d.astype(np.int32)), (p2, lead, s2, a[p2, s2].astype(np.int32))]
    w = {"legs": wave_legs, "score": rng.integers(0, 8, n).astype(np.float32),
         "ok": rng.random(n) < 0.9, "brokers3": legs == 2}
    w = wave_cases.flag_valid(w, a)
    if legs == 2:
        w["ok"] &= (a[wave_legs[1][0], 0] == wave_legs[0][3]) & (wave_legs[1][0] != p)
    ac, ag = _fresh(waves["ac"]), _fresh(waves["ag"])
    sel_c, sel_g = _k4_both(waves["sc"], waves["sg"], ac, ag, w)
    assert _bits(sel_c, sel_g) and int(sel_c.sum()) >= 2
    for f in ac._fields:
        assert _bits(ac._asdict()[f], ag._asdict()[f]), f


def test_k4_wave_over_3072_brokers():
    """One entry per broker of a 3,072-broker cluster (the bucketed smoke
    model's width), as the bulk planner's waves hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    cpu = generators.random_cluster(9, generators.ClusterProperty(
        num_racks=32, num_brokers=3072, num_topics=600, mean_partitions_per_topic=20.0,
        replication_factor=3, load_distribution="pareto", mean_utilization=0.5))
    dims = dims_of(cpu)
    sc = build_static_ctx(cpu, BalancingConstraint.default(), dims)
    sg = build_static_ctx(cpu.to("cuda"), BalancingConstraint.default(), dims)
    ac = compute_aggregates(sc, cpu.assignment, dims)
    ag = compute_aggregates(sg, cpu.assignment.cuda(), dims)
    w = wave_cases.flag_valid(
        wave_cases.bulk_width(cpu.assignment.numpy(), np.random.default_rng(10), 3072),
        cpu.assignment.numpy())
    sel_c, sel_g = _k4_both(sc, sg, ac, ag, w)
    assert sel_c.shape[0] == 3072 and int(sel_c.sum()) >= 100
    assert _bits(sel_c, sel_g)
    for f in ac._fields:
        assert _bits(ac._asdict()[f], ag._asdict()[f]), f


def test_k4_wave_with_no_valid_entry(waves):
    """Nothing flagged but actions that are not valid (src == dst, an empty
    slot): nothing selected, nothing written."""
    a = waves["arrays"]["assignment"]
    n = 64
    p = np.arange(n, dtype=np.int32)
    slot = np.zeros(n, np.int32)
    dst = a[p, 0].astype(np.int32)  # every move onto its own broker
    w = {"legs": [(p, np.zeros(n, np.int32), slot, dst)],
         "score": np.arange(n, dtype=np.float32), "ok": np.ones(n, bool), "brokers3": False}
    ac, ag = _fresh(waves["ac"]), _fresh(waves["ag"])
    sel_c, sel_g = _k4_both(waves["sc"], waves["sg"], ac, ag, wave_cases.flag_valid(w, a))
    assert _bits(sel_c, sel_g) and not bool(sel_g.any())
    sel_g = apply_wave(waves["sg"], ag, *(torch.from_numpy(x).cuda() for x in w["legs"][0]),
                       torch.from_numpy(w["score"]).cuda(), torch.ones(n, dtype=torch.bool,
                                                                      device="cuda"), 5)
    assert not bool(sel_g.any())
    for f in ac._fields:
        assert _bits(waves["ac"]._asdict()[f], ag._asdict()[f]), f


def test_k4_two_waves_in_a_row(waves):
    """The relay wave, then the bulk-width wave, on one context: the second
    equals the plain version after the first, and the same wave on a fresh
    context; the partition workspace is back at its sentinels after each
    launch."""
    first, second = waves["cases"]["relays_e_is_b"], waves["cases"]["bulk_width"]
    ac, ag = _fresh(waves["ac"]), _fresh(waves["ag"])
    _k4_both(waves["sc"], waves["sg"], ac, ag, first)
    assert _workspace_at_sentinels()
    sel_c, sel_g = _k4_both(waves["sc"], waves["sg"], ac, ag, second)
    assert _bits(sel_c, sel_g) and _workspace_at_sentinels()
    for f in ac._fields:
        assert _bits(ac._asdict()[f], ag._asdict()[f]), f
    fc, fg = _fresh(waves["ac"]), _fresh(waves["ag"])
    sel_fc, sel_fg = _k4_both(waves["sc"], waves["sg"], fc, fg, second)
    assert _bits(sel_fc, sel_fg)
    for f in fc._fields:
        assert _bits(fc._asdict()[f], fg._asdict()[f]), f


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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


def _window_tickets_clean():
    return not bool(ws._SCRATCH[torch.cuda.current_device()][1].any())


def _k2_both(c):
    args = [torch.from_numpy(c[f]) for f in ("contrib", "assignment", "movable")]
    rest = (c["k"], c["num_brokers"], c["heaviest"])
    want = broker_topk_plain(*args, *rest)
    got = broker_topk(*(t.cuda() for t in args), *rest)
    torch.cuda.synchronize()
    return want, got


@pytest.mark.parametrize("name", topk_cases.NAMES + tuple(f"k={k}" for k in topk_cases.KS))
def test_k2_crafted_cases(name):
    """tests/topk_cases.py at the card's sizes (the CPU tests hold the plain
    version to JAX on them): every output bit-equal, twice on the same
    scratch (K2 keeps no state between calls: the kernel writes every word
    of its scratch it reads)."""
    _card()
    c = topk_cases.case(name, full=True)
    want, got = _k2_both(c)
    assert topk_cases.occurs(name, c, want[2].numpy())
    for x, y in zip(want, got):
        assert _bits(x, y)
    _, again = _k2_both(c)
    for x, y in zip(want, again):
        assert _bits(x, y)


@pytest.mark.parametrize("k", topk_cases.KS)
@pytest.mark.parametrize("heaviest", [True, False])
def test_k2_bucketed_at_full_size(k, heaviest):
    """199,518 x 3 slots over 2,600 brokers padded to 3,072."""
    _card()
    c = dict(topk_cases.case("bucketed_3072", full=True), k=k, heaviest=heaviest)
    want, got = _k2_both(c)
    for x, y in zip(want, got):
        assert _bits(x, y)


def test_k2_leadership_and_light_calls_in_turn(pair):
    """drain.py's call pattern: heaviest=False then True on one leadership
    mask, brokers of both directions sharing the scratch."""
    _card()
    rng = np.random.default_rng(3)
    a = pair["ac"].assignment
    w = torch.from_numpy(rng.pareto(1.5, a.shape[0]).astype(np.float32))
    lead = torch.where(torch.arange(a.shape[1]) == 0, w[:, None], torch.tensor(-torch.inf))
    mov_c, mov_g = pair["sc"].movable_partition, pair["sg"].movable_partition
    for heaviest, k in ((False, 2), (True, 2), (False, 5), (True, 1)):
        want = broker_topk_plain(lead, a, mov_c, k, 24, heaviest)
        got = broker_topk(lead.cuda(), pair["ag"].assignment, mov_g, k, 24, heaviest)
        for x, y in zip(want, got):
            assert _bits(x, y)


WS_LENGTHS = (1, 31, 32, 33, 1023, 1024, 1025, 32767, 32768, 32769, 199518, 1048577,
              1 << 24, (1 << 24) + 1, (1 << 25) + 33)


@pytest.mark.parametrize("n", WS_LENGTHS)
def test_window_sum_lengths(n):
    """Every level boundary, and past 2**24 terms (the kernel's old limit);
    the tickets back at 0 after each call."""
    _card()
    rng = np.random.default_rng(n)
    x = (rng.pareto(1.5, n) * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    got = window_sum(torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    assert _bits(window_sum_plain(torch.from_numpy(x)), got), n
    assert _window_tickets_clean()


@pytest.mark.parametrize("cols", (1, 4, 1100))
@pytest.mark.parametrize("n", (1, 33, 1025, 32769))
def test_window_sum_columns(n, cols):
    """[n, cols] matrices; column 0 all -0.0, column 1 +inf and -inf (NaN),
    column 2 +inf, column 3 a NaN, as the plain version has them."""
    _card()
    rng = np.random.default_rng(n + cols)
    x = (rng.pareto(1.5, (n, cols)) * rng.choice([-1.0, 1.0], (n, cols))).astype(np.float32)
    x[:, 0] = -0.0
    if cols >= 4:
        x[n // 2, 1], x[n - 1, 1] = np.inf, -np.inf
        x[0, 2] = np.inf
        x[n // 3, 3] = np.nan
    got = window_sum(torch.from_numpy(x).cuda()).cpu()
    want = window_sum_plain(torch.from_numpy(x))
    # a NaN is compared as a NaN: the card's adds give its canonical NaN
    # (0x7fffffff) where x86's give 0xffc00000 or pass an input NaN's bits on
    nan = torch.isnan(want)
    assert torch.equal(nan, torch.isnan(got)), (n, cols)
    assert _bits(torch.where(nan, 0.0, want), torch.where(nan, 0.0, got)), (n, cols)
    assert _window_tickets_clean()


@pytest.mark.parametrize("order", (ws.UTILIZATION_COST, ws.EXCESS_COST),
                         ids=["utilization", "excess"])
@pytest.mark.parametrize("cols", (None, 1, 4, 40))
def test_window_sum_fused_orders(order, cols):
    """A fused cost's vectorized order (fault F4) at every length from 1 to
    33: the lanes from the order's first length to 32, index order around
    them; a vector and [n, cols] matrices."""
    _card()
    rng = np.random.default_rng(cols or 0)
    for n in range(1, 34):
        x = rng.uniform(0, 10, n if cols is None else (n, cols)).astype(np.float32)
        want = window_sum_plain(torch.from_numpy(x), order)
        got = window_sum(torch.from_numpy(x).cuda(), order)
        assert _bits(want, got), (n, cols)
    assert _window_tickets_clean()


def test_window_sum_bucketed_broker_axis():
    """3,072 brokers, the last 472 padding at 0.0, and the [3,072, 4] loads."""
    _card()
    rng = np.random.default_rng(5)
    x = rng.pareto(1.5, (3072, 4)).astype(np.float32)
    x[2600:] = 0.0
    for t in (torch.from_numpy(x[:, 1].copy()), torch.from_numpy(x)):
        assert _bits(window_sum_plain(t), window_sum(t.cuda()))
    assert _window_tickets_clean()


def test_k7_state_fingerprint(pair):
    assert int(state_fingerprint_plain(pair["ac"])) == int(state_fingerprint(pair["ag"]))
    flipped = pair["ag"]._replace(broker_load=pair["ag"].broker_load.clone())
    flipped.broker_load[3, 1] = -flipped.broker_load[3, 1]
    plain = state_fingerprint_plain(pair["ac"]._replace(broker_load=flipped.broker_load.cpu()))
    assert int(plain) == int(state_fingerprint(flipped)) != int(state_fingerprint(pair["ag"]))


FpAgg = collections.namedtuple("FpAgg", "broker_load leader_nw_in leader_count replica_count")


def _fp_agg(b, seed, offset=0):
    """K7's four arrays on the card from one buffer of random words (planted
    -0.0, +0.0 and NaN bit patterns among them), each a view `offset` words
    past a 16-byte boundary of its own."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    words = torch.randint(-2**31, 2**31, (7 * b + 16,), dtype=torch.int32, device="cuda",
                          generator=g)
    for k, bits in enumerate((-2**31, 0, 0x7FC00000, -0x003FFFFF, 0x7F800001)):
        words[k::97] = bits
    parts, at = [], 0
    for n in (4 * b, b, b, b):
        at = (at + 3) // 4 * 4 + offset  # every view starts `offset` words past a boundary
        parts.append(words[at:at + n])
        at += n
    load, lnw, lc, rc = parts
    return FpAgg(load.view(torch.float32).view(b, 4), lnw.view(torch.float32), lc, rc)


@pytest.mark.parametrize("b", [0, 1, 3, 2600, 3072, 300_001])
def test_k7_state_fingerprint_sizes(b):
    """K7 bit-equal to its plain version from one broker to 300,001 (the
    several-block layout and its ticket), on random words with signed zeros
    and NaN bit patterns."""
    _card()
    agg = _fp_agg(b, b)
    got = state_fingerprint(agg)
    assert got.dtype == torch.int64 and got.numel() == 1
    assert int(got) == int(state_fingerprint_plain(agg))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("b", [5, 3072, 300_001])
def test_k7_state_fingerprint_on_misaligned_views(b, offset):
    """Every array a slice of a larger tensor whose data pointer is not
    16-byte aligned: the scalar heads and tails and the vector bodies."""
    _card()
    agg = _fp_agg(b, 7 * b + offset, offset)
    assert all(t.data_ptr() % 16 == 4 * offset for t in agg)
    assert int(state_fingerprint(agg)) == int(state_fingerprint_plain(agg))


@pytest.mark.parametrize("b", [3072, 300_001])
def test_k7_back_to_back_calls_on_one_stream(b):
    """1,000 calls in a row on one stream, each a fresh output: the
    several-block layout's ticket is left at 0 by every launch."""
    _card()
    from cruise_control_torch.kernels import state_fingerprint as k7

    agg = _fp_agg(b, 11)
    want = int(state_fingerprint_plain(agg))
    outs = [state_fingerprint(agg) for _ in range(1000)]
    assert len({o.data_ptr() for o in outs}) == 1000
    assert torch.stack(outs).eq(want).all()
    assert int(k7._SCRATCH[torch.cuda.current_device()][0][0]) == 0


def test_k7_state_fingerprint_past_2_31_words():
    """4 * B = 2**31 load words (B = 2**29, 15 GB of aggregates): the 64-bit
    configuration, against the plain version summed in slices."""
    _card()
    from cruise_control_torch.kernels import state_fingerprint as k7

    b = 2**29
    agg = _fp_agg(b, 29)
    got = int(state_fingerprint(agg))
    want, step = 0, 2**26
    for (name, salt), t in zip(k7._SALTS, agg):
        flat = t.reshape(-1)
        for i in range(0, flat.shape[0], step):
            want += int(k7._mix(flat[i:i + step], salt, start=i))
    del agg
    torch.cuda.empty_cache()
    assert got == want & 0xFFFFFFFF


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
    (SERVICE_EXACT_SETTINGS, chunk budget 3 so that goals pause and resume)
    on the card against the CPU, and against the fused run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from cruise_control_torch import kernels
    from cruise_control_torch.analyzer.stats import stats_to_dict

    model = generators.random_cluster(42, FIXTURE_C)
    settings = dataclasses.replace(opt.SERVICE_EXACT_SETTINGS, chunk_rounds=3)
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


def _k10_batch(rng, d, n_live, b, p, m, unique, device):
    """A DeltaBatch of `n_live` rows of mixed kinds, then NOOP rows. With
    `unique`, no two landing rows share a target; without, targets repeat
    and some fall outside the axes."""
    from cruise_control_torch.analyzer.incremental import DeltaBatch

    cols = {k: np.zeros(d, np.int32) for k in ("kind", "broker", "state", "row", "topic")}
    cols["kind"][:n_live] = rng.integers(1, 4, n_live)
    if unique:
        # at most one state row per broker: the rest become load rows
        states = np.nonzero(cols["kind"] == 1)[0]
        cols["kind"][states[b:]] = 2
        cols["broker"][states[:b]] = rng.permutation(b)[:len(states[:b])]
        cols["row"][:n_live] = rng.permutation(p)[:n_live]
    else:
        cols["broker"][:n_live] = rng.integers(-b - 2, b + 2, n_live)
        cols["row"][:n_live] = np.where(rng.random(n_live) < 0.7, rng.integers(0, 8, n_live),
                                        rng.integers(-p - 2, p + 2, n_live))
    cols["state"][:n_live] = rng.integers(0, 4, n_live)
    cols["topic"][:n_live] = rng.integers(0, 50, n_live)
    load = np.zeros((d, m), np.float32)
    load[:n_live] = rng.random((n_live, m), dtype=np.float32)
    return DeltaBatch(**{k: torch.from_numpy(v).to(device) for k, v in cols.items()},
                      load=torch.from_numpy(load).to(device))


@pytest.mark.parametrize("size", ["small", "full"])
@pytest.mark.parametrize("unique", [True, False], ids=["distinct-targets", "repeated-targets"])
def test_k10_delta_scatter(size, unique):
    """K10 against its plain version on random batches, at the small
    cluster's bucketed shape and at the smoke model's (212,992 x 3,072):
    every field exact, the input context unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from cruise_control_torch.kernels.delta_scatter import delta_scatter, delta_scatter_plain

    prop = PROP if size == "small" else dataclasses.replace(
        generators.BASELINE_CONFIGS[5], num_dead_brokers=26, load_distribution="pareto",
        mean_utilization=0.5)
    model = generators.random_cluster(42, prop)
    ctx_c = opt.GoalOptimizer(settings=opt.SERVICE_SETTINGS, device="cpu")._build_ctx(model)
    ctx_g = opt.GoalOptimizer(settings=opt.SERVICE_SETTINGS, device="cuda")._build_ctx(model)
    sc, sg = ctx_c[3], ctx_g[3]
    b, (p, m) = ctx_c[2].num_brokers, tuple(sc.part_load.shape)
    rng = np.random.default_rng(7 if unique else 8)
    for n_live in (0, 1, 20, 64):
        batch = _k10_batch(rng, 64, n_live, b, p, m, unique, "cpu")
        base_rep, base_lead = (torch.from_numpy(rng.random(b) < 0.9) for _ in range(2))
        want = delta_scatter_plain(sc, batch, base_rep, base_lead)
        before = [t.clone() for t in sg]
        got = delta_scatter(sg, type(batch)(*(t.cuda() for t in batch)), base_rep.cuda(),
                            base_lead.cuda())
        torch.cuda.synchronize()
        for f in want._fields:
            assert _bits(getattr(got, f), getattr(want, f)), (n_live, f)
        assert all(torch.equal(x, y) for x, y in zip(before, sg))


def test_bucketed_service_and_lane_on_the_card_equal_the_cpu():
    """The service's bucketed solve (SERVICE_SETTINGS) of a 70-broker cluster
    (padded to 80) and a lane proposal on it (a load spike, a broker death
    and a partition add) on the card against the CPU: assignment, touch tags,
    digest; the lane launches K10 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from cruise_control_torch import kernels
    from cruise_control_torch.analyzer import incremental as inc
    from cruise_control_torch.analyzer.context import OptimizationOptions

    model = generators.random_cluster(7, generators.ClusterProperty(
        num_racks=7, num_brokers=70, num_topics=20, mean_partitions_per_topic=10.0,
        replication_factor=2, num_dead_brokers=1))
    pl = model.part_load.clone()
    pl[model.topic_id == 3] *= 4.0
    st = model.broker_state.clone()
    st[5] = 3
    a = model.assignment
    fresh = model._replace(
        assignment=torch.cat([a, torch.tensor([[0, 1], [2, 3]], dtype=a.dtype)]),
        part_load=torch.cat([pl, torch.full((2, pl.shape[1]), 0.03)]),
        topic_id=torch.cat([model.topic_id, torch.tensor([4, 4], dtype=torch.int32)]),
        broker_state=st)
    out = []
    for d in ("cpu", "cuda"):
        o = opt.GoalOptimizer(settings=opt.SERVICE_SETTINGS, device=d)
        full = o.optimizations(model, None, raise_on_hard_failure=False)
        lane = inc.IncrementalLane(o)
        assert lane.arm(model, OptimizationOptions(), [g.name for g in full.goal_results], 1)
        kernels.reset_launches()
        prop_ = lane.propose(fresh, 2)
        assert prop_.ok, prop_.fallback_reason
        if d == "cuda":
            assert kernels.launches()["delta_scatter"] == 1
        out.append((full, prop_.result))
    for cpu_res, gpu_res in zip(*out):
        names = [g.name for g in cpu_res.goal_results]
        assert np.array_equal(cpu_res.final_assignment, gpu_res.final_assignment)
        assert np.array_equal(cpu_res.touch_tag, gpu_res.touch_tag)
        assert cpu_res.provenance.digest(goals=names) == gpu_res.provenance.digest(goals=names)
        assert cpu_res.bucketed == gpu_res.bucketed


# -- the immigrant term, goal case 15, K11, K8 over few topics -------------------------


def _flagged(static, flag: bool):
    return static._replace(only_move_immigrants=torch.tensor(flag, device=static.dead.device))


KA_NAMES = ["KafkaAssignerEvenRackAwareGoal", "KafkaAssignerDiskUsageDistributionGoal"]
CASE_GOALS = KA_NAMES + ["RackAwareGoal", "CpuUsageDistributionGoal"]


@pytest.mark.parametrize("flag", [False, True], ids=["flag-off", "immigrants"])
@pytest.mark.parametrize("name", CASE_GOALS)
def test_k3_case_15_and_the_immigrant_flag(pair, name, flag):
    """K3 with goal case 15 (and the kafka-assigner disk goal's case 11
    under case 15's tables) and the default stack's goals, with the
    only_move_immigrants flag off and on: finite masks and scores exact."""
    stack = goals_by_priority(KA_NAMES if name in KA_NAMES else None)
    g = next(x for x in stack if x.name == name)
    priors = stack[:stack.index(g)]
    sc, sg = _flagged(pair["sc"], flag), _flagged(pair["sg"], flag)
    tc = build_tables(priors, sc, pair["ac"], pair["dims"])
    tg = build_tables(priors, sg, pair["ag"], pair["dims"])
    gsc, gsg = g.prepare(sc, pair["ac"], pair["dims"]), g.prepare(sg, pair["ag"], pair["dims"])
    a = pair["ac"].assignment
    p = torch.arange(a.shape[0], dtype=torch.int32)[:, None, None]
    s = torch.arange(a.shape[1], dtype=torch.int32)[None, :, None]
    d = torch.arange(24, dtype=torch.int32)[None, None, :]
    kind = torch.tensor(KIND_MOVE, dtype=torch.int32)
    finite = 0
    for idx_c in ((p, kind, s, d), leadership_grid(a)):
        idx_g = tuple(t.cuda() for t in idx_c)
        want = score_candidates_plain(sc, pair["ac"], tc, g, gsc, *idx_c)
        got = score_candidates(sg, pair["ag"], tg, g, gsg, *idx_g).cpu()
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got))
        assert _bits(want[fin], got[fin])
        finite += int(fin.sum())
    assert finite > 0


@pytest.mark.parametrize("flag", [False, True], ids=["flag-off", "immigrants"])
@pytest.mark.parametrize("name", KA_NAMES + ["DiskCapacityGoal"])
def test_k9_case_15_and_the_immigrant_flag(pair, name, flag):
    from cruise_control_torch.kernels.grid_shortlist import grid_shortlist, grid_shortlist_plain

    stack = goals_by_priority(KA_NAMES if name in KA_NAMES else None)
    g = next(x for x in stack if x.name == name)
    priors = stack[:stack.index(g)]
    sc, sg = _flagged(pair["sc"], flag), _flagged(pair["sg"], flag)
    tc = build_tables(priors, sc, pair["ac"], pair["dims"])
    tg = build_tables(priors, sg, pair["ag"], pair["dims"])
    gsc, gsg = g.prepare(sc, pair["ac"], pair["dims"]), g.prepare(sg, pair["ag"], pair["dims"])
    cands = opt.dst_candidates(sc, gsc, pair["ac"], g, pair["dims"], 4, tc)
    want = grid_shortlist_plain(sc, pair["ac"], tc, g, gsc, cands)
    got = grid_shortlist(sg, pair["ag"], tg, g, gsg, cands.cuda())
    for w, x in zip(want, got):
        assert _bits(w, x), (name, flag, want, got)


@pytest.mark.parametrize("flag", [False, True], ids=["flag-off", "immigrants"])
def test_k5_with_the_immigrant_flag(pair, flag):
    """K5's three kinds on random cells (the replica-swap grid and its wave
    form, topic swaps, relays) with the flag off and on; with it on, the
    grid, the topic swaps and the relays reject every cell."""
    from cruise_control_torch.kernels.score_swaps import (
        LEADERSHIP_RELAY,
        REPLICA_SWAP,
        TOPIC_SWAP,
        score_swaps,
        score_swaps_plain,
    )

    rng = np.random.default_rng(17)
    a = pair["ac"].assignment.numpy()
    goals = goals_by_priority(None)
    sc, sg = _flagged(pair["sc"], flag), _flagged(pair["sg"], flag)
    n = 4000
    held = np.argwhere(a >= 0)
    c1, c2 = held[rng.integers(0, len(held), n)], held[rng.integers(0, len(held), n)]
    cells = [c1[:, 0], c1[:, 1], a[c1[:, 0], c1[:, 1]], c2[:, 0], c2[:, 1], a[c2[:, 0], c2[:, 1]]]
    swap = tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)) for x in cells)
    lead = np.nonzero(a[:, 0] >= 0)[0]
    p1 = lead[rng.integers(0, len(lead), n)]
    s1 = rng.integers(1, a.shape[1], n)
    dd = a[p1, s1]
    p2 = np.array([np.nonzero(a[:, 0] == x)[0][0] if (a[:, 0] == x).any() else 0 for x in dd])
    relay = tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)) for x in (
        p1, s1, a[p1, 0], p2, rng.integers(1, a.shape[1], n), dd))
    for kind, gi, idx, wave in ((REPLICA_SWAP, 8, swap, False), (REPLICA_SWAP, 8, swap, True),
                                (TOPIC_SWAP, 12, swap, False),
                                (LEADERSHIP_RELAY, 14, relay, False)):
        g = goals[gi]
        tc = build_tables(goals[:gi], sc, pair["ac"], pair["dims"])
        tg = build_tables(goals[:gi], sg, pair["ag"], pair["dims"])
        gsc, gsg = g.prepare(sc, pair["ac"], pair["dims"]), g.prepare(sg, pair["ag"], pair["dims"])
        res = getattr(g, "resource", 0)
        want = score_swaps_plain(kind, sc, pair["ac"], tc, gsc, *idx, resource=res, wave=wave)
        got = score_swaps(kind, sg, pair["ag"], tg, gsg, *(t.cuda() for t in idx), resource=res,
                          wave=wave).cpu()
        assert torch.equal(torch.isfinite(want), torch.isfinite(got)), (kind, wave)
        assert _bits(torch.where(torch.isfinite(want), want, 0.0),
                     torch.where(torch.isfinite(got), got, 0.0))
        if flag and not wave:
            assert not torch.isfinite(want).any(), kind


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (5000, 3), (199, 4)])
def test_k11_elect_preferred(shape):
    """K11 against its plain version: random rows with -1 slots anywhere,
    random demoted and dead masks; a fresh output, the input unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from cruise_control_torch.kernels.elect_preferred import elect_preferred, elect_preferred_plain

    rng = np.random.default_rng(shape[0])
    b = 30
    a = torch.from_numpy(rng.integers(0, b, shape).astype(np.int32))
    a[torch.from_numpy(rng.random(shape) < 0.2)] = -1
    dead = torch.from_numpy(rng.random(b) < 0.2)
    demoted = torch.from_numpy(rng.random(b) < 0.3) & ~dead
    want = elect_preferred_plain(a, demoted, dead)
    ag = a.cuda()
    got = elect_preferred(ag, demoted.cuda(), dead.cuda())
    assert got.data_ptr() != ag.data_ptr()
    assert _bits(want, got) and torch.equal(ag.cpu(), a)


def _k11_inputs(p, r, b, seed, empty=0.2, dead_share=0.2, demoted_share=0.3):
    """A random [p, r] assignment over b brokers (distinct brokers a row
    where r <= b, -1 slots anywhere) and demoted and dead masks, on the
    card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randint(0, b, (p, r), dtype=torch.int32, device="cuda", generator=g)
    a[torch.rand((p, r), device="cuda", generator=g) < empty] = -1
    dead = torch.rand(b, device="cuda", generator=g) < dead_share
    demoted = (torch.rand(b, device="cuda", generator=g) < demoted_share) & ~dead
    return a, demoted, dead


def _k11_forced(a, demoted, dead, flags):
    """K11's C entry with its flag layout forced ("bytes" or "global"): the
    output, or None where the entry refuses."""
    from cruise_control_torch.kernels import build
    from cruise_control_torch.kernels import elect_preferred as k11m

    p, r = a.shape
    b = demoted.shape[0]
    out = torch.full((p, r), -2, dtype=torch.int32, device="cuda")
    code = build.entry("elect_preferred", k11m._ARGTYPES)(
        a.data_ptr(), demoted.data_ptr(), dead.data_ptr(), out.data_ptr(),
        k11m._workspace(a.get_device(), b), p, r, b, k11m.FLAGS[flags], build.raw_stream(0))
    return None if code else out


def _k11_check(a, demoted, dead, flags=None):
    """K11 (the wrapper, or its C entry with the flag layout `flags` forced)
    equal to the plain version, the input unchanged."""
    from cruise_control_torch.kernels.elect_preferred import elect_preferred, elect_preferred_plain

    before = a.clone()
    got = (elect_preferred(a, demoted, dead) if flags is None
           else _k11_forced(a, demoted, dead, flags))
    assert got is not None
    want = elect_preferred_plain(a, demoted, dead)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(a, before)
    return got


@pytest.mark.parametrize("flags", [None, "global"])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 6, 7, 8, 24, 25])
def test_k11_rows_and_flag_layouts(r, flags):
    """R from 1 to 8, 24 (512-row tiles at the tile's word limit) and 25
    (fewer rows a tile) over 1,027 and 5,001 rows (no multiple of a tile)
    and one row, with the flags chosen by the wrapper (bytes) and forced
    to the bits read in place: equal to the plain version, the input
    unchanged."""
    _card()
    for p in (1, 1_027, 5_001):
        _k11_check(*_k11_inputs(p, r, 40, seed=p * 10 + r), flags=flags)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_k11_misaligned_view(offset):
    """An assignment that starts 1-3 words past a 16-byte boundary (a view
    into a larger tensor), and masks that do: the scalar heads and tails."""
    _card()
    a, demoted, dead = _k11_inputs(4_099, 3, 50, seed=offset)
    big = torch.full((4_099 * 3 + 8,), -7, dtype=torch.int32, device="cuda")
    view = big[offset:offset + a.numel()].view(4_099, 3)
    view.copy_(a)
    both =torch.zeros(2 * 50 + offset, dtype=torch.bool, device="cuda")
    dem_v, dead_v = both[offset:offset + 50], both[offset + 50:]
    dem_v.copy_(demoted)
    dead_v.copy_(dead)
    _k11_check(view, dem_v, dead_v)
    _k11_check(view, demoted, dead)
    assert bool((big[:offset] == -7).all()) and bool((big[offset + a.numel():] == -7).all())


def test_k11_every_leader_ineligible():
    """Every leader on a dead or demoted broker: each row with an eligible
    follower swaps with its first; rows without one keep theirs."""
    _card()
    a, _, _ = _k11_inputs(3_001, 3, 60, seed=5, empty=0.1)
    a[:, 0] = a[:, 0].abs() % 30  # every leader among brokers 0-29, every one of them out
    dead = torch.arange(60, device="cuda") < 15
    demoted = (torch.arange(60, device="cuda") >= 15) & (torch.arange(60, device="cuda") < 30)
    got = _k11_check(a, demoted, dead)
    assert bool((got[:, 0] != a[:, 0]).any()) and bool((got[:, 0] == a[:, 0]).any())


@pytest.mark.parametrize("b", [49_152, 49_153, 393_217])
def test_k11_past_the_byte_flag_limit(b):
    """49,152 brokers (the byte flags' 48 KB), 49,153 and 393,217 (past it:
    the bits read in place), and the byte flags forced past their limit
    refused by the C entry."""
    _card()
    a, demoted, dead = _k11_inputs(200_003, 3, b, seed=b % 97, dead_share=0.05,
                                   demoted_share=0.05)
    _k11_check(a, demoted, dead)
    _k11_check(a, demoted, dead, flags="global")
    if b > 49_152:
        assert _k11_forced(a, demoted, dead, "bytes") is None
    else:
        _k11_check(a, demoted, dead, flags="bytes")


@pytest.mark.parametrize("r", [3_072, 3_073, 4_000])
def test_k11_rows_too_wide_for_a_tile(r):
    """R at the 4-row tile's limit and past it (a block a row)."""
    _card()
    _k11_check(*_k11_inputs(301, r, 5_000, seed=r, dead_share=0.3, demoted_share=0.3))


def test_k11_past_2_31_words():
    """P * R past 2**31 words (715,827,884 rows of 3, about 17 GB with the
    output): the 64-bit configuration, equal to the plain version in
    slices."""
    _card()
    from cruise_control_torch.kernels.elect_preferred import elect_preferred, elect_preferred_plain

    p, r, b = 2**31 // 3 + 1_001, 3, 2_600
    g = torch.Generator(device="cuda").manual_seed(31)
    a = torch.empty((p, r), dtype=torch.int32, device="cuda")
    step = 2**24
    for i in range(0, p, step):
        n = min(step, p - i)
        a[i:i + n] = torch.randint(-1, b, (n, r), dtype=torch.int32, device="cuda", generator=g)
    dead = torch.rand(b, device="cuda", generator=g) < 0.01
    demoted = (torch.rand(b, device="cuda", generator=g) < 0.01) & ~dead
    got = elect_preferred(a, demoted, dead)
    torch.cuda.synchronize()
    for i in range(0, p, step):
        n = min(step, p - i)
        assert torch.equal(got[i:i + n], elect_preferred_plain(a[i:i + n], demoted, dead)), i
    del a, got
    torch.cuda.empty_cache()


@pytest.mark.parametrize("b", [24, 40])
@pytest.mark.parametrize("t", [1, 2, 7, 20, 28, 32, 33])
def test_k8_cluster_stats_over_few_topics(t, b):
    """K8's mean over 32 or fewer topics in the vectorized order (TOPIC_LANES,
    both broker-axis classes), and windowed above: bit-equal to the plain
    version on random count tables with per-topic scales."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    rng = np.random.default_rng(t * 100 + b)
    counts = rng.integers(0, rng.integers(2, 24, (t, 1)) + 1, (t, b)).astype(np.int32)
    counts[rng.random(t) < 0.5, rng.integers(0, b)] += 1000
    load = rng.pareto(1.5, (b, 4)).astype(np.float32)
    args = (torch.from_numpy(load), torch.full((b, 4), 100.0),
            torch.from_numpy(rng.random(b) < 0.9), torch.from_numpy(counts.sum(0, dtype=np.int32)),
            torch.from_numpy(counts.sum(0, dtype=np.int32) // 2),
            torch.from_numpy(load[:, 2].copy()),
            torch.from_numpy(counts))
    out_c = cluster_stats_plain(*args)
    out_g = cluster_stats(*(x.cuda() for x in args))
    torch.cuda.synchronize()
    for x, y in zip(out_c, out_g):
        assert _bits(x, y)


def test_options_and_kafka_assigner_on_the_card_equal_the_cpu():
    """The service path (SERVICE_SETTINGS, bucketed) on the card against the
    CPU: under only_move_immigrants with two more dead brokers and a tenth of
    the partitions excluded, under the goal-violation multiplier, and the
    kafka-assigner request; assignment, touch tags and digest equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from cruise_control_torch import kernels
    from cruise_control_torch.analyzer.context import OptimizationOptions
    from cruise_control_torch.kernels.score_candidates import score_candidates as k3

    model = generators.random_cluster(42, FIXTURE_C)
    st = model.broker_state.clone()
    st[torch.tensor([3, 17])] = 3
    p = model.num_partitions
    relaxed = dataclasses.replace(BalancingConstraint.default(),
                                  goal_violation_distribution_threshold_multiplier=2.5)
    for m, goals, options, constraint in (
            (model._replace(broker_state=st), None,
             OptimizationOptions(only_move_immigrants=True,
                                 excluded_partitions=np.arange(p) % 10 == 0), None),
            (model, None, OptimizationOptions(is_triggered_by_goal_violation=True), relaxed),
            (model, KA_NAMES, OptimizationOptions(), None)):
        kernels.reset_launches()
        res = [opt.GoalOptimizer(constraint=constraint, settings=opt.SERVICE_SETTINGS,
                                 device=d).optimizations(m, goals, options,
                                                         raise_on_hard_failure=False)
               for d in ("cpu", "cuda")]
        if goals == KA_NAMES:
            assert k3.cases[15] > 0
        names = [g.name for g in res[0].goal_results]
        assert np.array_equal(res[0].final_assignment, res[1].final_assignment)
        assert np.array_equal(res[0].touch_tag, res[1].touch_tag)
        assert res[0].provenance.digest(goals=names) == res[1].provenance.digest(goals=names)


# -- K3's three paths, K9 on ties, the score context ---------------------------------

ALL_CASES = STACK_IDS + ["KafkaAssignerEvenRackAwareGoal"]


def _goal_and_priors(name):
    stack = goals_by_priority(KA_NAMES if name in KA_NAMES else None)
    g = next(x for x in stack if x.name == name)
    return g, stack[:stack.index(g)]


def _side(static, agg, dims, name):
    """(goal, tables, gs) of goal `name` under its priors' tables."""
    g, priors = _goal_and_priors(name)
    return g, build_tables(priors, static, agg, dims), g.prepare(static, agg, dims)


def _k3_path(sc, ac, sg, ag, dims, name, make, path):
    """K3 on the card against its plain version on the CPU, on the index
    tensors make(agg) builds on each side; the launch must take `path`.
    Returns the number of finite cells."""
    gc, tc, gsc = _side(sc, ac, dims, name)
    gg, tg, gsg = _side(sg, ag, dims, name)
    before = score_candidates.paths[path]
    want = score_candidates_plain(sc, ac, tc, gc, gsc, *make(ac))
    got = score_candidates(sg, ag, tg, gg, gsg, *make(ag)).cpu()
    assert score_candidates.paths[path] == before + 1, dict(score_candidates.paths)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert _bits(want[fin], got[fin])
    return int(fin.sum())


def _factored_layouts(a, num_brokers):
    """name -> make(agg): the factored path's index layouts. The drain grid
    [V, K, C] toward C = 20 and C = 200 destinations (the tile is 32 and 128
    columns wide) and toward C = 2 and C = 3 (a two- or three-broker
    cluster: tiles of 2 and 4 columns, whose rows the shared memory bounds),
    some of them -1 and repeated; the pair drain's per-row destination lists
    [V, 1, C] for C = 20 and 2; the all-broker re-score [k, B]."""
    rng = np.random.default_rng(11)
    p = rng.integers(0, a.shape[0], (16, 4, 1)).astype(np.int32)
    s = rng.integers(0, a.shape[1], (16, 4, 1)).astype(np.int32)
    d20 = rng.integers(-1, num_brokers, (1, 1, 20)).astype(np.int32)
    d200 = rng.integers(-1, num_brokers, (1, 1, 200)).astype(np.int32)
    rows = rng.integers(0, num_brokers, (16, 1, 20)).astype(np.int32)
    # 600 rows, so that the narrow tiles' row limit is reached more than once
    pn = rng.integers(0, a.shape[0], (150, 4, 1)).astype(np.int32)
    sn = rng.integers(0, a.shape[1], (150, 4, 1)).astype(np.int32)
    d2 = rng.choice(num_brokers, (1, 1, 2), replace=False).astype(np.int32)
    d3 = np.array([[[-1, 0, 1]]], dtype=np.int32)
    rows2 = rng.integers(0, num_brokers, (600, 1, 2)).astype(np.int32)
    pr = rng.integers(0, a.shape[0], (600, 1, 1)).astype(np.int32)
    sr = rng.integers(0, a.shape[1], (600, 1, 1)).astype(np.int32)
    kp = rng.integers(0, a.shape[0], (5, 1)).astype(np.int32)
    ks = rng.integers(0, a.shape[1], (5, 1)).astype(np.int32)

    def grid(dst, p=p, s=s):
        def make(agg):
            dev = agg.assignment.device
            t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
            return t(p), torch.tensor(KIND_MOVE, dtype=torch.int32, device=dev), t(s), t(dst)
        return make

    def all_brokers(agg):
        dev = agg.assignment.device
        t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        return (t(kp), torch.full((5, 1), KIND_MOVE, dtype=torch.int32, device=dev), t(ks),
                torch.arange(num_brokers, dtype=torch.int32, device=dev)[None, :])

    return {"drain C=20": grid(d20), "drain C=200": grid(d200), "pair drain": grid(rows),
            "all brokers": all_brokers, "drain C=2": grid(d2, pn, sn),
            "drain C=3": grid(d3, pn, sn), "pair drain C=2": grid(rows2, pr, sr)}


NARROW = ("drain C=2", "drain C=3", "pair drain C=2")
#: the layouts whose dst depends on the first axis: a thread a cell
PER_ROW = ("pair drain", "pair drain C=2")


@pytest.fixture
def tiles_at_any_size(monkeypatch):
    """The factored path's size floor at 0, so that these small grids take
    the tiles (at their full size the drain grids do), with a layout cache
    of their own."""
    monkeypatch.setattr(k3_module, "FACTORED_MIN_CELLS", 0)
    monkeypatch.setattr(k3_module, "_LAYOUTS", {})


@pytest.mark.parametrize("name", ALL_CASES)
def test_k3_factored_path(pair, name, tiles_at_any_size):
    total = 0
    for layout, make in _factored_layouts(pair["ac"].assignment, 24).items():
        total += _k3_path(pair["sc"], pair["ac"], pair["sg"], pair["ag"], pair["dims"], name,
                          make, "promotion" if layout in PER_ROW else "factored")
    assert total > 0 or name in ("KafkaAssignerEvenRackAwareGoal",)


@pytest.fixture(scope="module")
def rf_pairs(pair):
    """Seeded clusters at replication factors 2, 3 and 4 (3 is `pair`'s)."""
    out = {3: (pair["sc"], pair["ac"], pair["sg"], pair["ag"], pair["dims"])}
    for rf in (2, 4):
        cpu = generators.random_cluster(43 + rf, dataclasses.replace(PROP, replication_factor=rf))
        gpu = cpu.to("cuda")
        dims = dims_of(cpu)
        c = dataclasses.replace(BalancingConstraint.default(), max_replicas_per_broker=80)
        sc, sg = build_static_ctx(cpu, c, dims), build_static_ctx(gpu, c, dims)
        out[rf] = (sc, compute_aggregates(sc, cpu.assignment, dims), sg,
                   compute_aggregates(sg, gpu.assignment, dims), dims)
    return out


@pytest.mark.parametrize("rf", [2, 3, 4])
@pytest.mark.parametrize("name", STACK_IDS)
def test_k3_promotion_path(rf_pairs, name, rf):
    """The [P, R-1] leadership grid (drain.py) and the bulk planner's
    [B, K, R-1] leadership cells, one thread per row."""
    sc, ac, sg, ag, dims = rf_pairs[rf]
    rng = np.random.default_rng(rf)
    cand = rng.integers(0, ac.assignment.shape[0], (24, 8, 1)).astype(np.int32)

    def bulk_cells(agg):
        dev = agg.assignment.device
        p3 = torch.from_numpy(cand).to(dev)
        slots = torch.arange(1, rf, dtype=torch.int32, device=dev)[None, None, :]
        kind = torch.tensor(KIND_LEADERSHIP, dtype=torch.int32, device=dev)
        return p3, kind, slots, agg.assignment[p3.long(), slots.long()]

    for make in (lambda agg: leadership_grid(agg.assignment), bulk_cells):
        _k3_path(sc, ac, sg, ag, dims, name, make, "promotion")


@pytest.mark.parametrize("rf", [2, 3, 4])
@pytest.mark.parametrize("name", STACK_IDS)
def test_k3_factored_narrow_tiles(rf_pairs, name, rf, tiles_at_any_size):
    """The factored path toward two and three destinations at R = 2, 3 and 4:
    tiles of 2 and 4 columns, as many rows as the shared memory holds."""
    sc, ac, sg, ag, dims = rf_pairs[rf]
    layouts = _factored_layouts(ac.assignment, dims.num_brokers)
    for layout in NARROW:
        _k3_path(sc, ac, sg, ag, dims, name, layouts[layout],
                 "promotion" if layout in PER_ROW else "factored")


def test_k3_full_size_drain_grid_takes_the_tiles(pair):
    """At the drain round's [512, 8, 64] the tiles are taken as the rounds
    call K3, with no size floor changed."""
    rng = np.random.default_rng(12)
    p = rng.integers(0, pair["ac"].assignment.shape[0], (512, 8, 1)).astype(np.int32)
    s = rng.integers(0, pair["ac"].assignment.shape[1], (512, 8, 1)).astype(np.int32)
    d = np.resize(np.arange(-1, 24, dtype=np.int32), 64).reshape(1, 1, 64)

    def make(agg):
        dev = agg.assignment.device
        t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        return t(p), torch.tensor(KIND_MOVE, dtype=torch.int32, device=dev), t(s), t(d)

    assert _k3_path(pair["sc"], pair["ac"], pair["sg"], pair["ag"], pair["dims"],
                    "DiskCapacityGoal", make, "factored") > 0


@pytest.mark.parametrize("rf", [1, 2])
def test_two_broker_cluster_on_the_card_equals_the_cpu(rf, tiles_at_any_size):
    """A two-broker cluster, whose drain grids, pair drain and all-broker
    re-score are two columns wide, solved by the fused stack and the service
    on the card against the CPU; with the size floor at 0, K3 takes its
    factored path on tiles of two columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    model = generators.random_cluster(7, dataclasses.replace(
        PROP, num_racks=2, num_brokers=2, num_topics=12, mean_partitions_per_topic=6.0,
        replication_factor=rf, num_dead_brokers=0))
    for settings in (opt.STACK_SETTINGS, opt.SERVICE_SETTINGS):
        before = score_candidates.paths["factored"]
        res = [opt.GoalOptimizer(settings=settings, device=d).optimizations(
            model, None, raise_on_hard_failure=False) for d in ("cpu", "cuda")]
        assert score_candidates.paths["factored"] > before
        assert np.array_equal(res[0].final_assignment, res[1].final_assignment)
        assert np.array_equal(res[0].touch_tag, res[1].touch_tag)
        for a, b in zip(res[0].goal_results, res[1].goal_results):
            assert (a.violated_brokers_after, a.rounds, a.converged, a.cost_after) == (
                b.violated_brokers_after, b.rounds, b.converged, b.cost_after)


@pytest.mark.parametrize("flag", [False, True], ids=["flag-off", "immigrants"])
@pytest.mark.parametrize("name", ALL_CASES)
def test_k3_general_path(pair, name, flag):
    """512 single cells, as a drain wave re-scores them: moves and
    promotions, a -1 destination, src == dst, empty slots, dead sources,
    with only_move_immigrants off and on."""
    sc, sg = _flagged(pair["sc"], flag), _flagged(pair["sg"], flag)
    a = pair["ac"].assignment.numpy()
    rng = np.random.default_rng(7)
    n = 512
    p = rng.integers(0, a.shape[0], n).astype(np.int32)
    kind = (rng.random(n) < 0.25).astype(np.int32)
    slot = rng.integers(0, a.shape[1], n).astype(np.int32)
    slot[kind == KIND_LEADERSHIP] = rng.integers(1, a.shape[1], int(kind.sum()))
    dst = rng.integers(0, 24, n).astype(np.int32)
    dst[:16] = -1
    dst[16:32] = a[p[16:32], slot[16:32]]  # src == dst for a move
    empty = np.nonzero(a[:, 2] < 0)[0]
    p[32:48], slot[32:48], kind[32:48] = empty[:16], 2, KIND_MOVE
    dead = np.nonzero(pair["sc"].dead.numpy())[0]
    on_dead = np.argwhere(np.isin(a, dead))
    pick = on_dead[rng.integers(0, len(on_dead), 64)]
    p[48:112], slot[48:112], kind[48:112] = pick[:, 0], pick[:, 1], KIND_MOVE
    lead = kind == KIND_LEADERSHIP
    dst[lead] = a[p[lead], slot[lead]]

    def make(agg):
        dev = agg.assignment.device
        return tuple(torch.from_numpy(x).to(dev) for x in (p, kind, slot, dst))

    _k3_path(sc, pair["ac"], sg, pair["ag"], pair["dims"], name, make, "general")


def _k9_both(sc, sg, ac, ag, dims, name, cands):
    from cruise_control_torch.kernels.grid_shortlist import grid_shortlist, grid_shortlist_plain

    gc, tc, gsc = _side(sc, ac, dims, name)
    gg, tg, gsg = _side(sg, ag, dims, name)
    want = grid_shortlist_plain(sc, ac, tc, gc, gsc, cands)
    got = grid_shortlist(sg, ag, tg, gg, gsg, cands.cuda())
    for w, x in zip(want, got):
        assert _bits(w, x), (name, want, got)
    return [int(x) if x.dtype != torch.float32 else float(x) for x in want]


def _only_movable(static, ps):
    m = torch.zeros_like(static.movable_partition)
    m[torch.as_tensor(ps).long()] = True
    return static._replace(movable_partition=m)


@pytest.mark.parametrize("k", [4, 7, 11])
@pytest.mark.parametrize("name", ["DiskCapacityGoal", "ReplicaDistributionGoal",
                                  "LeaderReplicaDistributionGoal", "RackAwareGoal",
                                  "TopicReplicaDistributionGoal", "KafkaAssignerEvenRackAwareGoal"])
def test_k9_cells_not_a_multiple_of_a_warp(pair, name, k):
    """R x K = 12, 21 and 33 move cells a partition (a warp takes 32)."""
    cands = torch.from_numpy(np.random.default_rng(k).permutation(24)[:k].astype(np.int32))
    _k9_both(pair["sc"], pair["sg"], pair["ac"], pair["ag"], pair["dims"], name, cands)


@pytest.fixture(scope="module")
def twins():
    """The pair cluster with partition 40 a copy of partition 9 (row, load,
    topic) and partition 3 a copy of 61, both with a replica on a dead
    broker: equal cells, so equal bests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    cpu = generators.random_cluster(42, PROP)
    fields = {k: v.clone() for k, v in cpu._asdict().items()}
    for dst_p, src_p in ((40, 9), (3, 61)):
        for f in ("assignment", "part_load", "topic_id"):
            fields[f][dst_p] = fields[f][src_p]
    cpu = from_numpy({k: v.numpy() for k, v in fields.items()})
    gpu = cpu.to("cuda")
    dims = dims_of(cpu)
    c = dataclasses.replace(BalancingConstraint.default(), max_replicas_per_broker=80)
    sc, sg = build_static_ctx(cpu, c, dims), build_static_ctx(gpu, c, dims)
    return (sc, sg, compute_aggregates(sc, cpu.assignment, dims),
            compute_aggregates(sg, gpu.assignment, dims), dims)


@pytest.mark.parametrize("twin", [(9, 40), (3, 61)])
@pytest.mark.parametrize("name", ["DiskCapacityGoal", "ReplicaDistributionGoal",
                                  "LeaderReplicaDistributionGoal", "RackAwareGoal"])
def test_k9_two_partitions_with_the_same_best(twins, name, twin):
    """Only the two twins may move: they tie, and the lower p wins."""
    sc, sg, ac, ag, dims = twins
    sc, sg = _only_movable(sc, twin), _only_movable(sg, twin)
    cands = torch.arange(24, dtype=torch.int32)[::3].contiguous()
    score, p, *_ = _k9_both(sc, sg, ac, ag, dims, name, cands)
    assert np.isfinite(score) or name != "DiskCapacityGoal"
    if np.isfinite(score):
        assert p == min(twin)


def test_k9_a_promotion_equal_to_the_best_move(pair):
    """LeaderReplicaDistributionGoal with no prior tables: moving the leader
    to a broker d scores as promoting a follower on broker b where d and b
    lead as many partitions. Only that partition moves, toward d alone: the
    two tie and the move wins."""
    from cruise_control_torch.analyzer.acceptance import empty_tables
    from cruise_control_torch.kernels.grid_shortlist import grid_shortlist, grid_shortlist_plain

    sc, ac, dims = pair["sc"], pair["ac"], pair["dims"]
    g, _ = _goal_and_priors("LeaderReplicaDistributionGoal")
    t = empty_tables(dims, "cpu")
    gs = g.prepare(sc, ac, dims)
    a, lead = ac.assignment, ac.leader_count
    found = None
    for p in range(a.shape[0]):
        for s in range(1, a.shape[1]):
            b = int(a[p, s])
            if b < 0:
                continue
            for d in range(24):
                if d in a[p].tolist() or int(lead[d]) != int(lead[b]):
                    continue
                i32 = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
                mv = score_candidates_plain(sc, ac, t, g, gs, i32(p), i32(KIND_MOVE), i32(0),
                                            i32(d))
                pr = score_candidates_plain(sc, ac, t, g, gs, i32(p), i32(KIND_LEADERSHIP),
                                            i32(s), i32(b))
                if torch.isfinite(mv).all() and _bits(mv, pr):
                    found = (p, d)
                    break
            if found:
                break
        if found:
            break
    assert found is not None, "the fixture holds no tied move and promotion"
    p, d = found
    sc1, sg1 = _only_movable(sc, [p]), _only_movable(pair["sg"], [p])
    cands = torch.tensor([d], dtype=torch.int32)
    want = grid_shortlist_plain(sc1, ac, t, g, gs, cands)
    got = grid_shortlist(sg1, pair["ag"], empty_tables(dims, "cuda"), g,
                         g.prepare(sg1, pair["ag"], dims), cands.cuda())
    for w, x in zip(want, got):
        assert _bits(w, x)
    assert int(want[2]) == KIND_MOVE and int(want[1]) == p


@pytest.mark.parametrize("name", ["DiskCapacityGoal", "LeaderReplicaDistributionGoal"])
def test_k9_every_cell_minus_inf(pair, name):
    """Nothing movable: p 0, slot 0, the first candidate, score -inf (a
    score is either above SCORE_EPS or -inf, so -0.0 never bids)."""
    sc = pair["sc"]._replace(movable_partition=torch.zeros_like(pair["sc"].movable_partition))
    sg = pair["sg"]._replace(movable_partition=torch.zeros_like(pair["sg"].movable_partition))
    cands = torch.tensor([5, 9, 2, 17, 11], dtype=torch.int32)
    score, p, kind, slot, dst = _k9_both(sc, sg, pair["ac"], pair["ag"], pair["dims"], name,
                                         cands)
    assert (score, p, kind, slot, dst) == (-np.inf, 0, KIND_MOVE, 0, 5)


def test_a_rebound_context_scores_like_a_fresh_one(pair):
    """A context built on one aggregate, called with another (as after the
    lane's K10 returns fresh outputs): it is rebuilt, counted, and scores
    as a fresh context and the plain version do."""
    from cruise_control_torch.kernels.grid_shortlist import grid_shortlist, grid_shortlist_plain
    from cruise_control_torch.kernels.score_candidates import ScoreContext

    dims = pair["dims"]
    g, tg, gsg = _side(pair["sg"], pair["ag"], dims, "DiskCapacityGoal")
    ctx = ScoreContext(pair["sg"], pair["ag"], tg, g, gsg)
    make = _factored_layouts(pair["ac"].assignment, 24)["drain C=20"]
    score_candidates(pair["sg"], pair["ag"], tg, g, gsg, *make(pair["ag"]), ctx=ctx)
    ag2 = type(pair["ag"])(*(t.clone() for t in pair["ag"]))
    ag2.broker_load[3] += 1000.0
    ag2.replica_count[5] += 3
    ac2 = type(ag2)(*(t.cpu() for t in ag2))
    rebuilds = ScoreContext.rebuilds
    got = score_candidates(pair["sg"], ag2, tg, g, gsg, *make(ag2), ctx=ctx)
    assert ScoreContext.rebuilds == rebuilds + 1 and ctx.agg is ag2
    fresh = score_candidates(pair["sg"], ag2, tg, g, gsg, *make(ag2))
    gc, tc, gsc = _side(pair["sc"], ac2, dims, "DiskCapacityGoal")
    want = score_candidates_plain(pair["sc"], ac2, tc, gc, gsc, *make(ac2))
    assert _bits(got, fresh) and _bits(got, want)
    assert ctx.struct.assignment == ag2.assignment.data_ptr()
    cands = torch.tensor([5, 9, 2, 17], dtype=torch.int32)
    got9 = grid_shortlist(pair["sg"], pair["ag"], tg, g, gsg, cands.cuda(), ctx=ctx)
    assert ScoreContext.rebuilds == rebuilds + 2 and ctx.agg is pair["ag"]
    gc0, tc0, gsc0 = _side(pair["sc"], pair["ac"], dims, "DiskCapacityGoal")
    for w, x in zip(grid_shortlist_plain(pair["sc"], pair["ac"], tc0, gc0, gsc0, cands), got9):
        assert _bits(w, x)


# -- past the old size limits, and K5 / K6 redesigned ---------------------------------


def _sides(cpu, hosts_of=None):
    """(static, agg) on the CPU and on the card of a generated cluster, with
    `hosts_of(num_brokers)` as its broker -> host map where given."""
    if hosts_of is not None:
        cpu = cpu._replace(broker_host=hosts_of(cpu.num_brokers))
    dims = dims_of(cpu)
    sc = build_static_ctx(cpu, BalancingConstraint.default(), dims)
    sg = build_static_ctx(cpu.to("cuda"), BalancingConstraint.default(), dims)
    return dims, sc, compute_aggregates(sc, cpu.assignment, dims), sg, compute_aggregates(
        sg, cpu.assignment.cuda(), dims)


def _k4_equal(sc, sg, ac, ag, w):
    ac, ag = _fresh(ac), _fresh(ag)
    sel_c, sel_g = _k4_both(sc, sg, ac, ag, w)
    assert _bits(sel_c, sel_g)
    for f in ac._fields:
        assert _bits(ac._asdict()[f], ag._asdict()[f]), f
    assert _workspace_at_sentinels()
    return int(sel_c.sum())


#: a cluster wider than K4's block configuration (5,000 brokers; the bulk
#: planner's waves hold one entry per broker, 5,120 bucketed)
WIDE_PROP = generators.ClusterProperty(num_racks=50, num_brokers=5000, num_topics=1000,
                                       mean_partitions_per_topic=20.0, replication_factor=3,
                                       load_distribution="pareto", mean_utilization=0.5)


def test_k4_one_leg_wave_of_5120_entries():
    """A bulk-width wave of 5,120 entries (one per broker, past the block
    configuration's 4,096), three brokers a host: K4's wide configuration,
    bit-equal to the plain version."""
    _card()
    cpu = generators.random_cluster(12, dataclasses.replace(WIDE_PROP, num_brokers=5120))
    dims, sc, ac, sg, ag = _sides(cpu, lambda b: torch.arange(b, dtype=torch.int32) // 3)
    a = cpu.assignment.numpy()
    w = wave_cases.flag_valid(wave_cases.bulk_width(a, np.random.default_rng(13), 5120), a)
    assert len(w["score"]) == 5120
    assert _k4_equal(sc, sg, ac, ag, w) >= 100


@pytest.mark.parametrize("legs", [1, 2])
def test_k4_wave_over_9000_brokers(legs):
    """1,024 entries over 9,000 brokers and 3,000 hosts (past the block
    configuration's 8,192 groups): random moves and promotions, or relays
    claiming a third broker."""
    _card()
    cpu = generators.random_cluster(14, dataclasses.replace(
        WIDE_PROP, num_brokers=9000, num_racks=90, num_topics=2000))
    dims, sc, ac, sg, ag = _sides(cpu, lambda b: torch.arange(b, dtype=torch.int32) // 3)
    a = cpu.assignment.numpy()
    rng = np.random.default_rng(15 + legs)
    n = 1024
    p = rng.integers(0, a.shape[0], n).astype(np.int32)
    if legs == 1:
        kind = (rng.random(n) < 0.4).astype(np.int32)
        slot = np.where(kind == 1, rng.integers(1, 3, n), rng.integers(0, 3, n)).astype(np.int32)
        dst = np.where(kind == 1, a[p, slot], rng.integers(0, 9000, n)).astype(np.int32)
        wave_legs = [(p, kind, slot, dst)]
    else:
        lead = np.ones(n, np.int32)
        s1 = rng.integers(1, 3, n).astype(np.int32)
        d = a[p, s1]
        order = np.argsort(a[:, 0], kind="stable")
        first = np.searchsorted(a[order, 0], np.arange(9001))
        p2 = np.asarray([order[first[x] + rng.integers(0, first[x + 1] - first[x])]
                         if x >= 0 and first[x + 1] > first[x] else 0 for x in d], np.int32)
        s2 = rng.integers(1, 3, n).astype(np.int32)
        wave_legs = [(p, lead, s1, d.astype(np.int32)), (p2, lead, s2, a[p2, s2].astype(np.int32))]
    w = {"legs": wave_legs, "score": rng.integers(0, 8, n).astype(np.float32),
         "ok": rng.random(n) < 0.9, "brokers3": legs == 2}
    w = wave_cases.flag_valid(w, a)
    if legs == 2:
        w["ok"] &= (a[wave_legs[1][0], 0] == wave_legs[0][3]) & (wave_legs[1][0] != p)
    assert _k4_equal(sc, sg, ac, ag, w) >= 50


@pytest.mark.parametrize("case", ["not_a_candidate", "signed_zeros", "shared_source_hosts",
                                  "relays_e_is_b", "bulk_width"])
def test_k4_crafted_waves_in_the_wide_configuration(waves, case):
    """tests/wave_cases.py's waves padded past 4,096 entries with unflagged
    ones: the wide configuration selects and applies as the plain version."""
    w = wave_cases.pad(waves["cases"][case], 4100)
    assert len(w["score"]) == 4100
    ac, ag = _fresh(waves["ac"]), _fresh(waves["ag"])
    sel_c, sel_g = _k4_both(waves["sc"], waves["sg"], ac, ag, w)
    assert _bits(sel_c, sel_g) and w["occurs"](sel_c.numpy())
    for f in ac._fields:
        assert _bits(ac._asdict()[f], ag._asdict()[f]), f
    assert _workspace_at_sentinels()


@pytest.mark.parametrize("heaviest", [True, False])
def test_k2_over_40000_brokers(heaviest):
    """40,000 brokers (past the 32,768 whose counters fit a block's shared
    memory): each block counts in its row of the runs table."""
    _card()
    rng = np.random.default_rng(41)
    p, r, b = 30000, 3, 40000
    a = rng.integers(0, b, (p, r)).astype(np.int32)
    a[rng.random((p, r)) < 0.05] = -1
    a[:2000, 0] = 7  # one broker with many slots
    c = rng.integers(-3, 4, (p, r)).astype(np.float32)
    c[rng.random((p, r)) < 0.05] = -np.inf
    mv = rng.random(p) < 0.95
    args = [torch.from_numpy(x) for x in (c, a, mv)]
    want = broker_topk_plain(*args, 4, b, heaviest)
    got = broker_topk(*(t.cuda() for t in args), 4, b, heaviest)
    for x, y in zip(want, got):
        assert _bits(x, y)
    assert bool(want[2].any()) and not bool(want[2].all())


@pytest.mark.parametrize("name", ["RackAwareGoal", "DiskCapacityGoal",
                                  "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
                                  "NetworkInboundUsageDistributionGoal"])
def test_k9_replication_factor_17(name):
    """R = 17: a partition's 34 halves take more than a warp's 32 lanes."""
    _card()
    cpu = generators.random_cluster(5, generators.ClusterProperty(
        num_racks=20, num_brokers=40, num_topics=30, mean_partitions_per_topic=6.0,
        replication_factor=17, num_dead_brokers=2, load_distribution="pareto",
        mean_utilization=0.5))
    dims, sc, ac, sg, ag = _sides(cpu)
    assert dims.max_rf == 17
    for k in (4, 16):
        cands = torch.from_numpy(np.random.default_rng(k).permutation(40)[:k].astype(np.int32))
        _k9_both(sc, sg, ac, ag, dims, name, cands)


@pytest.mark.parametrize("unique", [True, False], ids=["distinct-targets", "repeated-targets"])
def test_k10_batch_of_4096_rows(unique):
    """A 4,096-row batch (the later of two rows to one target at any
    distance in the batch), on a 600-broker model's bucketed context."""
    _card()
    from cruise_control_torch.kernels.delta_scatter import delta_scatter, delta_scatter_plain

    model = generators.random_cluster(42, dataclasses.replace(WIDE_PROP, num_brokers=600,
                                                              num_topics=300))
    ctx_c = opt.GoalOptimizer(settings=opt.SERVICE_SETTINGS, device="cpu")._build_ctx(model)
    ctx_g = opt.GoalOptimizer(settings=opt.SERVICE_SETTINGS, device="cuda")._build_ctx(model)
    sc, sg = ctx_c[3], ctx_g[3]
    b, (p, m) = ctx_c[2].num_brokers, tuple(sc.part_load.shape)
    rng = np.random.default_rng(9)
    batch = _k10_batch(rng, 4096, 4000, b, p, m, unique, "cpu")
    base_rep, base_lead = (torch.from_numpy(rng.random(b) < 0.9) for _ in range(2))
    want = delta_scatter_plain(sc, batch, base_rep, base_lead)
    got = delta_scatter(sg, type(batch)(*(t.cuda() for t in batch)), base_rep.cuda(),
                        base_lead.cuda())
    for f in want._fields:
        assert _bits(getattr(got, f), getattr(want, f)), f


def _k10_static(pair, b, p, m, seed, misaligned=False):
    """(CPU, card) StaticCtx whose fields K10 reads are random: [P, M] loads
    with signed zeros and NaN bits, topic ids, states 0-3, validity and a
    partition count; `misaligned`: the card's loads a view one float past a
    16-byte boundary."""
    rng = np.random.default_rng(seed)
    load = rng.random((p, m), dtype=np.float32)
    load.reshape(-1)[::13] = -0.0
    load.view(np.int32).reshape(-1)[5::101] = 0x7FC00001
    fields = dict(part_load=load, topic_id=rng.integers(0, 500, p).astype(np.int32),
                  broker_state=rng.integers(0, 4, b).astype(np.int32),
                  broker_valid=rng.random(b) < 0.9,
                  num_valid_partitions=np.float32(p - 3))
    sc = pair["sc"]._replace(**{k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()})
    sg = type(sc)(*(t.cuda() for t in sc))
    if misaligned:
        buf = torch.empty(p * m + 1, device="cuda")
        buf[1:] = sg.part_load.reshape(-1)
        sg = sg._replace(part_load=buf[1:].view(p, m))
        assert sg.part_load.data_ptr() % 16 == 4
    return sc, sg


def _k10_both(sc, sg, batch, base_rep, base_lead):
    from cruise_control_torch.kernels.delta_scatter import delta_scatter, delta_scatter_plain

    want = delta_scatter_plain(sc, batch, base_rep, base_lead)
    before = [t.clone() for t in sg]
    got = delta_scatter(sg, type(batch)(*(t.cuda() for t in batch)), base_rep.cuda(),
                        base_lead.cuda())
    torch.cuda.synchronize()
    for f in want._fields:
        assert _bits(getattr(got, f), getattr(want, f)), f
    assert all(_bits(x, y) for x, y in zip(before, sg))  # NaN bits too


@pytest.mark.parametrize("d", [0, 1, 64, 2049, 4096])
@pytest.mark.parametrize("unique", [True, False], ids=["distinct-targets", "repeated-targets"])
def test_k10_batch_sizes(pair, d, unique):
    """Batches of 0 to 4,096 rows (all landing rows, then NOOPs) into 2,600
    brokers and 9,000 partition rows of 6 floats (several tiles, a ragged
    last one)."""
    b, p, m = 2600, 9000, 6
    sc, sg = _k10_static(pair, b, p, m, d)
    rng = np.random.default_rng(d + 1)
    batch = _k10_batch(rng, d, d - d // 8, b, p, m, unique, "cpu")
    base_rep, base_lead = (torch.from_numpy(rng.random(b) < 0.9) for _ in range(2))
    _k10_both(sc, sg, batch, base_rep, base_lead)


@pytest.mark.parametrize("m,misaligned", [(6, False), (5, True)], ids=["aligned", "misaligned"])
def test_k10_targets_at_tile_edges(pair, m, misaligned):
    """Targets on the last row of a block's tile and the first of the next
    (state, load row and topic), each named twice, directly and from the end,
    in both orders; the ragged last tile; and, misaligned, load rows that are
    a view off a 16-byte boundary (the word-at-a-time copy)."""
    from cruise_control_torch.analyzer.incremental import DeltaBatch
    from cruise_control_torch.kernels.delta_scatter import TILE

    b, p = 2 * TILE + 5, 3 * TILE + 7
    sc, sg = _k10_static(pair, b, p, m, m, misaligned)
    edges = [TILE - 1, TILE, 2 * TILE - 1, 2 * TILE, p - 1, 0]
    rows = []
    for i, e in enumerate(edges):
        for kind in (1, 2, 3):
            n = b if kind == 1 else p
            if e >= n:
                continue
            first, second = (e, e - n) if i % 2 else (e - n, e)
            rows += [(kind, first, i), (kind, second, i + 10)]
    d = len(rows) + 3
    cols = {k: np.zeros(d, np.int32) for k in ("kind", "broker", "state", "row", "topic")}
    load = np.zeros((d, m), np.float32)
    for k, (kind, idx, tag) in enumerate(rows):
        cols["kind"][k] = kind
        cols["broker" if kind == 1 else "row"][k] = idx
        cols["state"][k], cols["topic"][k] = tag % 4, 1000 + tag
        load[k] = tag + np.arange(m, dtype=np.float32) / 8
    batch = DeltaBatch(**{k: torch.from_numpy(v) for k, v in cols.items()},
                       load=torch.from_numpy(load))
    rng = np.random.default_rng(m)
    base_rep, base_lead = (torch.from_numpy(rng.random(b) < 0.9) for _ in range(2))
    _k10_both(sc, sg, batch, base_rep, base_lead)


@pytest.fixture(scope="module")
def swap_model():
    """A 600-broker cluster, wide enough for the rounds' full K5 grids."""
    _card()
    cpu = generators.random_cluster(23, dataclasses.replace(
        WIDE_PROP, num_brokers=600, num_racks=30, num_topics=300, num_dead_brokers=6))
    dims, sc, ac, sg, ag = _sides(cpu)
    return dict(dims=dims, sc=sc, ac=ac, sg=sg, ag=ag)


def _k5_grid(side, dims, kind):
    """(goal, tables, gs, index tensors) of the rounds' full-size K5 grid of
    `kind` on one side: [128, 128, 8, 8], [512, 16, 8] or [512, 4, 2, 8, 2]."""
    from cruise_control_torch.analyzer import drain, swaps
    from cruise_control_torch.kernels.score_swaps import LEADERSHIP_RELAY, REPLICA_SWAP

    st, agg = side
    name = {REPLICA_SWAP: "DiskUsageDistributionGoal",
            LEADERSHIP_RELAY: "LeaderBytesInDistributionGoal"}.get(
        kind, "TopicReplicaDistributionGoal")
    g, tables, gs = _side(st, agg, dims, name)
    if kind == REPLICA_SWAP:
        grid = swaps.swap_grid(st, agg, g.resource, g.drain_contrib(st, gs, agg).contiguous(),
                               128, 8, dims.num_brokers)[-1]
    elif kind == LEADERSHIP_RELAY:
        grid = drain.relay_grid(st, agg, gs, g, 0, 512, 4, 8, dims.num_brokers)[-1]
    else:
        grid = drain.topic_swap_grid(st, agg, tables, gs, 0, 512, 16, 8, dims.num_topics,
                                     dims.num_brokers)[-1]
    return g, tables, gs, grid


def _k5_both(m, kind, edit=None):
    """K5 on the card against its plain version on the CPU, on the grid of
    `kind`, edited by edit(grid) on both sides; returns (finite cells, path
    launched)."""
    from cruise_control_torch.kernels.score_swaps import score_swaps, score_swaps_plain

    g, tc, gsc, grid_c = _k5_grid((m["sc"], m["ac"]), m["dims"], kind)
    _, tg, gsg, grid_g = _k5_grid((m["sg"], m["ag"]), m["dims"], kind)
    for x, y in zip(grid_c, grid_g):
        assert _bits(x, y)
    if edit is not None:
        grid_c = edit([t.clone() for t in grid_c])
        grid_g = [t.cuda() for t in grid_c]
    res = getattr(g, "resource", 0)
    before = dict(score_swaps.paths)
    want = score_swaps_plain(kind, m["sc"], m["ac"], tc, gsc, *grid_c, resource=res)
    got = score_swaps(kind, m["sg"], m["ag"], tg, gsg, *grid_g, resource=res).cpu()
    fin = torch.isfinite(want)
    assert want.shape == got.shape
    assert torch.equal(fin, torch.isfinite(got))
    assert _bits(want[fin], got[fin])
    path = [k for k, v in score_swaps.paths.items() if v != before.get(k, 0)]
    return int(fin.sum()), path


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["replica-swap", "topic-swap", "relay"])
def test_k5_full_size_grids(swap_model, kind):
    """Each kind at the rounds' full grid shape: the replica-swap grid on the
    staged path, the topic-swap and relay grids a thread a cell."""
    finite, path = _k5_both(swap_model, kind)
    assert path == (["staged"] if kind == 0 else ["cells"])
    assert finite > 0


@pytest.mark.parametrize("path", ["staged", "cells"])
@pytest.mark.parametrize("edit", ["masked rows", "stray pick"])
def test_k5_replica_swap_grid_with_masked_and_stray_picks(swap_model, edit, path, monkeypatch):
    """The replica-swap grid, on the staged path and forced a thread a cell,
    with a hot broker's picks masked, a cold broker's picks masked, a masked
    hot and a masked cold broker; and with a pick that is not on its grid
    broker (its cells scored in the reference's form)."""
    from cruise_control_torch.kernels import score_swaps as k5

    if path == "cells":
        monkeypatch.setattr(k5, "STAGED_MIN_CELLS", 1 << 40)
        monkeypatch.setattr(k5, "_LAYOUTS", {})
    def masked(grid):
        p1, s1, hot, p2, s2, cold = grid
        p1[3] = -1
        p2[:, 5] = -1
        hot[9] = -1
        cold[:, 7] = -1
        p1[20, 0, 1, 0] = -1
        return (p1, s1, hot, p2, s2, cold)

    def stray(grid):
        p1, s1, hot, p2, s2, cold = grid
        p1[11, 0, 2, 0], s1[11, 0, 2, 0] = p1[12, 0, 2, 0], s1[12, 0, 2, 0]
        p2[0, 30, 0, 1], s2[0, 30, 0, 1] = p2[0, 31, 0, 1], s2[0, 31, 0, 1]
        return (p1, s1, hot, p2, s2, cold)

    finite, took = _k5_both(swap_model, 0, masked if edit == "masked rows" else stray)
    assert took == [path] and finite > 0


@pytest.mark.parametrize("k", [1, 4, 8])
def test_k6_one_pass(pair, k):
    """K6 at k = 1, 4 and 8: rows with fewer than k slots and a row with
    none, bit-equal to the plain version; at most two launches a call, and
    the scratch back at its state after each."""
    from cruise_control_torch.kernels import pair_picks as k6

    rng = np.random.default_rng(30 + k)
    a = pair["ac"].assignment
    topic = pair["sc"].topic_id
    pair_b = torch.from_numpy(rng.permutation(24)[:12].astype(np.int32))
    held = [int(topic[int(np.argwhere(a.numpy() == b)[0][0])]) for b in pair_b[:9].tolist()]
    on_last = set(topic[(a == int(pair_b[-1])).any(dim=1)].tolist())
    none = min(set(range(60)) - on_last)
    pair_t = torch.tensor(held + list(rng.integers(0, 60, 2)) + [none], dtype=torch.int32)
    want = pair_picks_plain(a, topic, pair["sc"].movable_partition, pair_t, pair_b, k, 24)
    args = (pair["ag"].assignment, pair["sg"].topic_id, pair["sg"].movable_partition,
            pair_t.cuda(), pair_b.cuda(), k, 24)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = pair_picks(*args)
        torch.cuda.synchronize()
    for x, y in zip(want, got):
        assert _bits(x, y)
    found = want[2]
    assert not bool(found[-1].any()), "a row with no slot"
    if k > 1:
        assert bool((found.any(dim=1) & ~found.all(dim=1)).any()), "a row with fewer than k"
    launches = [e for e in prof.events() if e.name.split("(")[0].split("<")[0].split(" ")[-1]
                .startswith("k_pair")]
    assert 0 < len(launches) <= 2, [e.name for e in launches]
    row_of, lists, ticket = k6._SCRATCH[torch.cuda.current_device()]
    assert bool((row_of == -1).all()) and bool((lists == torch.iinfo(torch.int32).max).all())
    assert int(ticket[0]) == 0


def test_k5_and_k6_read_nothing_back(swap_model, pair):
    """Once built, a K5 call of each kind (with a round's context) and a K6
    call synchronize nothing with the host."""
    from cruise_control_torch.kernels.score_swaps import score_swaps, swap_context

    m = swap_model
    calls = []
    for kind in (0, 1, 2):
        g, tg, gsg, grid = _k5_grid((m["sg"], m["ag"]), m["dims"], kind)
        ctx = swap_context(None, m["sg"], m["ag"], tg, gsg)
        calls.append(lambda kind=kind, tg=tg, gsg=gsg, grid=grid, ctx=ctx, res=getattr(
            g, "resource", 0): score_swaps(kind, m["sg"], m["ag"], tg, gsg, *grid, resource=res,
                                           ctx=ctx))
    pair_t = torch.zeros(8, dtype=torch.int32, device="cuda")
    pair_b = torch.arange(8, dtype=torch.int32, device="cuda")
    calls.append(lambda: pair_picks(pair["ag"].assignment, pair["sg"].topic_id,
                                    pair["sg"].movable_partition, pair_t, pair_b, 4, 24))
    for call in calls:
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_replica_distribution_on_5000_brokers_card_equals_cpu():
    """ReplicaDistributionGoal through the service machine (SERVICE_SETTINGS,
    bucketed to 5,120 brokers) on a 5,000-broker cluster: the bulk planner's
    waves take K4's wide configuration; the decision digest and the final
    assignment equal the CPU run's."""
    _card()
    model = generators.random_cluster(11, WIDE_PROP)
    waves_before = apply_wave.launches
    res = [opt.GoalOptimizer(device=d, settings=opt.SERVICE_SETTINGS).optimizations(
        model, ["ReplicaDistributionGoal"], raise_on_hard_failure=False) for d in ("cpu", "cuda")]
    assert apply_wave.launches > waves_before
    assert res[0].bucketed["padded"]["num_brokers"] == 5120
    assert res[0].provenance.digest() == res[1].provenance.digest()
    assert np.array_equal(res[0].final_assignment, res[1].final_assignment)
    assert res[0].num_replica_moves > 0


@pytest.mark.parametrize("k", [1, 4])
def test_k6_over_12288_brokers(k):
    """20,000 brokers (past the 12,288 whose pair rows fit a block's shared
    memory): K6's other configuration, the pair rows in a per-device table
    and the picks written by the pass's last block."""
    _card()
    from cruise_control_torch.kernels import pair_picks as k6

    rng = np.random.default_rng(50 + k)
    p, r, b, t = 30000, 3, 20000, 500
    a = rng.integers(0, b, (p, r)).astype(np.int32)
    a[rng.random((p, r)) < 0.05] = -1
    a[:40, :] = 11  # a pair with many slots
    topic = rng.integers(0, t, p).astype(np.int32)
    topic[:40] = 3
    mv = rng.random(p) < 0.95
    pair_b = rng.permutation(b)[:512].astype(np.int32)
    pair_b[0] = 11
    held = np.full(512, -1, np.int32)
    for v, x in enumerate(pair_b):
        rows = np.nonzero((a == x).any(axis=1))[0]
        held[v] = topic[rows[0]] if len(rows) else rng.integers(0, t)
    held[0] = 3
    args = [torch.from_numpy(x) for x in (a, topic, mv, held, pair_b)]
    want = pair_picks_plain(*args, k, b)
    got = pair_picks(*(x.cuda() for x in args), k, b)
    for x, y in zip(want, got):
        assert _bits(x, y)
    assert bool(want[2].any()) and bool(want[2][0].all())
    row_of, lists, ticket = k6._SCRATCH[torch.cuda.current_device()]
    assert bool((row_of == -1).all()) and bool((lists == torch.iinfo(torch.int32).max).all())
    assert int(ticket[0]) == 0


def _k1_case(name: str, r: int):
    """segment_aggregates' arguments (CPU tensors, then B, NR, H, T) for a
    crafted case at replication factor r: ~24,000 slots over 300 brokers,
    7 racks, 150 hosts (two brokers each, host 3 with four), 50 topics,
    pareto loads with some -0.0 rows and 5% empty slots; then the case's
    edit."""
    rng = np.random.default_rng(sum(map(ord, name)) + r)
    b, nr, h, t = 300, 7, 150, 50
    p = 24_000 // r
    if name == "runs span many chunks":  # ~300,000 slots: 74 chunks, ~1,000 a broker
        p = 300_000 // r
    a = rng.integers(0, b, (p, r)).astype(np.int32)
    a[rng.random((p, r)) < 0.05] = -1
    load = (rng.pareto(1.5, (p, 6)) * 10).astype(np.float32)
    load[::7] = -0.0
    host = (np.arange(b) // 2).astype(np.int32)
    host[[10, 11]] = 3
    topic = rng.integers(0, t, p).astype(np.int32)
    if name == "a broker with no slots":
        a[a == 5] = 6
        a[a == b - 1] = 0
    elif name == "one broker holding half the slots":
        a[rng.random((p, r)) < 0.5] = 17
    elif name == "every slot empty but one":
        a[:] = -1
        a[p // 2, r - 1] = 42
    elif name == "bucketed padding":  # the last 10% of partitions and 50 brokers padding
        pad = p - p // 10
        a[pad:] = -1
        load[pad:] = 0.0
        a[a >= 250] -= 50
    rack = (rng.permutation(b) % nr).astype(np.int32)
    args = [torch.from_numpy(x) for x in (a, load, topic, rack, host)]
    return args, (b, nr, h, t)


K1_CASES = ("a broker with no slots", "one broker holding half the slots",
            "every slot empty but one", "bucketed padding", "runs span many chunks")


@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("name", K1_CASES)
def test_k1_crafted_cases(name, r):
    """K1 at R = 1 and 8 bit-equal to its plain version on every output,
    twice on the same scratch (a broker holding half the slots takes the
    block of four warps)."""
    _card()
    from cruise_control_torch.kernels.segment_aggregates import (
        segment_aggregates,
        segment_aggregates_plain,
    )

    args, sizes = _k1_case(name, r)
    want = segment_aggregates_plain(*args, *sizes)
    for _ in range(2):
        got = segment_aggregates(*(x.cuda() for x in args), *sizes)
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(want, got)):
            assert _bits(x, y), (name, r, i)


def test_k1_at_the_bucketed_main_path_shape():
    """212,992 x 3 slots over 3,072 brokers (the last 472 and 13,474
    partitions empty), 52 racks, 4,096 topics."""
    _card()
    from cruise_control_torch.kernels.segment_aggregates import (
        segment_aggregates,
        segment_aggregates_plain,
    )

    rng = np.random.default_rng(11)
    p, r, b, nr, t = 212_992, 3, 3_072, 52, 4_096
    a = rng.integers(0, 2_600, (p, r)).astype(np.int32)
    a[199_518:] = -1
    load = rng.pareto(1.5, (p, 6)).astype(np.float32)
    load[199_518:] = 0.0
    args = [torch.from_numpy(x) for x in (
        a, load, rng.integers(0, 4_000, p).astype(np.int32),
        (np.arange(b) % nr).astype(np.int32), np.arange(b, dtype=np.int32))]
    want = segment_aggregates_plain(*args, b, nr, b, t)
    got = segment_aggregates(*(x.cuda() for x in args), b, nr, b, t)
    for i, (x, y) in enumerate(zip(want, got)):
        assert _bits(x, y), i


@pytest.mark.parametrize("b,t", [(300_000, 3), (40, 300_000)], ids=["300000-brokers",
                                                                  "300000-topics"])
def test_k8_past_its_old_shared_memory(b, t):
    """max(B, T) past the ~294,000 the old kernel's shared memory held."""
    _card()
    rng = np.random.default_rng(b + t)
    counts = rng.integers(0, 3, (t, b)).astype(np.int32)
    counts[rng.random(t) < 0.2] = 0
    load = rng.pareto(1.5, (b, 4)).astype(np.float32)
    args = (torch.from_numpy(load), torch.full((b, 4), 100.0),
            torch.from_numpy(rng.random(b) < 0.9), torch.from_numpy(counts.sum(0, dtype=np.int32)),
            torch.from_numpy(counts.sum(0, dtype=np.int32) // 2),
            torch.from_numpy(load[:, 2].copy()), torch.from_numpy(counts))
    want = cluster_stats_plain(*args)
    for _ in range(2):  # the counters are back at 0 after a launch
        got = cluster_stats(*(x.cuda() for x in args))
        for x, y in zip(want, got):
            assert _bits(x, y)


@pytest.mark.parametrize("n", [1, 2, 40, 300])
def test_window_sum_past_65535_column_tiles(n):
    """2,097,125 columns: past 65,535 tiles of 32, so each grid row takes
    two tiles (at n = 300 with several blocks a tile and their tickets)."""
    _card()
    cols = 65_535 * 32 + 5
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((n, cols)).astype(np.float32))
    want = window_sum_plain(x)
    got = window_sum(x.cuda())
    torch.cuda.synchronize()
    assert _bits(want, got)
    assert _window_tickets_clean()


def _wide_sides(r: int):
    """`pair`'s kind of cluster (24 brokers, RF 3) with its assignment padded
    by empty slots to r columns, on the CPU and on the card."""
    cpu = generators.random_cluster(42, dataclasses.replace(PROP, num_topics=20,
                                                            mean_partitions_per_topic=3.0))
    f = {k: v.numpy() for k, v in cpu._asdict().items()}
    a = np.full((f["assignment"].shape[0], r), -1, np.int32)
    a[:, :3] = f["assignment"]
    return _sides(from_numpy(dict(f, assignment=a)))


def test_k3_factored_tiles_past_the_48kb_row(tiles_at_any_size):
    """R = 12,300: an assignment row of 49,200 bytes, more than the tiles'
    static shared memory holds, so the cells read it in device memory."""
    _card()
    dims, sc, ac, sg, ag = _wide_sides(12_300)
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.integers(0, dims.num_partitions, (40, 1, 1)).astype(np.int32))
    s = torch.from_numpy(rng.integers(0, 3, (40, 1, 1)).astype(np.int32))

    def make(agg):
        dev = agg.assignment.device
        return (p.to(dev), torch.full((40, 1, 1), KIND_MOVE, dtype=torch.int32, device=dev),
                s.to(dev), torch.arange(24, dtype=torch.int32, device=dev)[None, None, :])

    for name in ("DiskCapacityGoal", "RackAwareGoal", "ReplicaDistributionGoal"):
        _k3_path(sc, ac, sg, ag, dims, name, make, "factored")


def test_k3_factored_tiles_past_65535_column_tiles(pair):
    """Two source rows (the first partitions with an acceptable move) against
    8,388,608 destinations cycling over the brokers: 65,536 column tiles of
    128."""
    _card()
    name, c = "ReplicaDistributionGoal", 65_536 * 128
    g, t, gs = _side(pair["sc"], pair["ac"], pair["dims"], name)
    brokers = torch.arange(24, dtype=torch.int32)[None, :]
    one = torch.ones((1, 1), dtype=torch.int32)
    rows = [p for p in range(pair["dims"].num_partitions) if torch.isfinite(
        score_candidates_plain(pair["sc"], pair["ac"], t, g, gs, one * p, one * KIND_MOVE, one,
                               brokers)).any()][:2]
    assert len(rows) == 2
    dst = (torch.arange(c, dtype=torch.int32) % 24)[None, None, :]

    def make(agg):
        dev = agg.assignment.device
        return (torch.tensor(rows, dtype=torch.int32, device=dev)[:, None, None],
                torch.full((2, 1, 1), KIND_MOVE, dtype=torch.int32, device=dev),
                torch.ones((2, 1, 1), dtype=torch.int32, device=dev), dst.to(dev))

    assert _k3_path(pair["sc"], pair["ac"], pair["sg"], pair["ag"], pair["dims"], name, make,
                    "factored") > 0


@pytest.mark.parametrize("name", ["DiskCapacityGoal", "ReplicaDistributionGoal",
                                  "LeaderReplicaDistributionGoal"])
def test_k9_replication_factor_2000(name):
    """R = 2,000 (padded with empty slots): a warp's halves overflow the
    block's shared memory, so the kernel keeps them in device memory."""
    _card()
    dims, sc, ac, sg, ag = _wide_sides(2_000)
    for k in (4, 16):
        cands = torch.from_numpy(np.random.default_rng(k).permutation(24)[:k].astype(np.int32))
        _k9_both(sc, sg, ac, ag, dims, name, cands)


def _served_service(device):
    """A 24-broker simulated cluster sampled for two 1 s windows on a
    scripted clock, the facade's optimizer on `device`, served on loopback
    by the port's server: (client, stop)."""
    from cruise_control_torch.async_ops import AsyncCruiseControl
    from cruise_control_torch.client.cccli import CruiseControlClient
    from cruise_control_torch.executor import Executor, SimulatorClusterDriver
    from cruise_control_torch.facade import CruiseControl, FacadeConfig
    from cruise_control_torch.monitor.completeness import ModelCompletenessRequirements
    from cruise_control_torch.monitor.load_monitor import LoadMonitor, LoadMonitorConfig
    from cruise_control_torch.monitor.metadata import MetadataClient
    from cruise_control_torch.monitor.sampler import TransportMetricSampler
    from cruise_control_torch.reporter.transport import InMemoryTransport
    from cruise_control_torch.servlet.server import CruiseControlApp, serve
    from cruise_control_torch.testing.simulator import SimulatedCluster

    sim = SimulatedCluster(generators.random_cluster(42, PROP))
    transport = InMemoryTransport()
    clock = {"now": 0.0}
    monitor = LoadMonitor(MetadataClient(sim.fetch_topology, ttl_s=0.0),
                          TransportMetricSampler(transport),
                          config=LoadMonitorConfig(window_ms=1000, num_windows=3,
                                                   min_samples_per_window=1),
                          clock=lambda: clock["now"])
    monitor.start_up()
    for r in range(3):
        transport.publish(sim.all_metrics(r * 1000 + 500))
        clock["now"] = r + 0.8
        monitor.sample_once()
    facade = CruiseControl(
        monitor, Executor(SimulatorClusterDriver(sim), load_monitor=monitor),
        optimizer=opt.GoalOptimizer(settings=opt.SERVICE_SETTINGS, device=device),
        config=FacadeConfig(default_requirements=ModelCompletenessRequirements(1, 0.5, False)))
    acc = AsyncCruiseControl(facade)
    handle = serve(CruiseControlApp(acc), "127.0.0.1", 0)

    def stop():
        handle.shutdown()
        acc.shutdown()

    return CruiseControlClient(handle.url, poll_interval_s=0.05), stop


def test_service_on_the_card_answers_rest_like_the_cpu():
    """The port's REST service with its solves on the card answers /load
    (K1 on the card) and a dry-run rebalance with the bodies the same
    service on the CPU gives, run ids and durations aside."""
    _card()
    from cruise_control_torch import kernels

    def strip(body):
        if isinstance(body, dict):
            return {k: strip(v) for k, v in body.items()
                    if k not in ("durationS", "provenanceRun")}
        return [strip(v) for v in body] if isinstance(body, list) else body

    out = {}
    for device in ("cpu", "cuda"):
        client, stop = _served_service(device)
        try:
            kernels.reset_launches()
            load = client.request("load")
            out[device] = (load, kernels.launches()["segment_aggregates"],
                           strip(client.request("rebalance", {"dryrun": "true"})))
        finally:
            stop()
    assert out["cuda"][1] > 0 and out["cpu"][1] == 0
    assert out["cuda"][0] == out["cpu"][0] and len(out["cuda"][0]["brokers"]) == 24
    assert out["cuda"][2] == out["cpu"][2] and out["cuda"][2]["proposals"]


# -- the partition-axis mesh: K12, K13 and the sharded shortlist ----------------

@pytest.mark.parametrize("kind", merge_cases.KINDS)
@pytest.mark.parametrize("n_dev,k_loc", merge_cases.SHAPES)
def test_k12_shard_merge(kind, n_dev, k_loc):
    """K12 against its plain version (tests/merge_cases.py, which
    test_torch_spmd.py holds to JAX's lexsort) for k_sel 1, k_loc and all
    the records."""
    _card()
    from cruise_control_torch.kernels.shard_merge import shard_merge, shard_merge_plain

    rng = np.random.default_rng([merge_cases.KINDS.index(kind), n_dev, k_loc])
    s, rec = (torch.from_numpy(x) for x in merge_cases.records(kind, n_dev, k_loc, rng))
    for k_sel in sorted({1, k_loc, n_dev * k_loc}):
        want = shard_merge_plain(s, rec, k_sel)
        before = shard_merge.launches
        got = shard_merge(s.cuda(), rec.cuda(), k_sel)
        torch.cuda.synchronize()
        assert shard_merge.launches == before + 1
        assert _bits(want[0], got[0]) and _bits(want[1], got[1]), (kind, k_sel)


def test_k12_refuses_what_it_does_not_take():
    _card()
    from cruise_control_torch.kernels.shard_merge import shard_merge

    s, rec = torch.zeros(4, device="cuda"), torch.zeros((4, 4), dtype=torch.int32, device="cuda")
    for bad in ((s.double(), rec, 1), (s, rec[:, :3].contiguous(), 1), (s, rec.t(), 1),
                (s, rec, 0), (s[:0], rec[:0], 1)):
        with pytest.raises((TypeError, ValueError)):
            shard_merge(*bad)


@pytest.mark.parametrize("n,r", [(0, 3), (1, 1), (1000, 3), (199520, 3), (4097, 17)])
def test_k13_partition_stats(n, r):
    """K13 against its plain version, three calls back to back (the last
    block leaves its accumulators at 0), the last into a row of a gather
    buffer."""
    _card()
    from cruise_control_torch.kernels.partition_stats import (
        partition_stats,
        partition_stats_plain,
    )

    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.integers(-1, 50, (n, r)).astype(np.int32))
    movable = torch.from_numpy(rng.random(n) < 0.7)
    want = partition_stats_plain(movable, a)
    assert want.tolist() == [int(movable.sum()), int((a >= 0).sum()), n]
    ag, mg = a.cuda(), movable.cuda()
    for _ in range(2):
        assert _bits(want, partition_stats(mg, ag))
    buf = torch.full((2, 3), -7, dtype=torch.int32, device="cuda")
    partition_stats(mg, ag, out=buf[1])
    torch.cuda.synchronize()
    assert _bits(want, buf[1]) and buf[0].tolist() == [-7, -7, -7]


def test_mesh_shortlist_and_stats_on_the_card(pair):
    """On a mesh of 4 shards of the card: each goal's sharded shortlist
    equals the unsharded K9 and the plain sharded shortlist, the partition
    stats the host's counts; K9 launches once a shard and K12 once."""
    from cruise_control_torch.kernels.grid_shortlist import grid_shortlist
    from cruise_control_torch.kernels.partition_stats import partition_stats
    from cruise_control_torch.kernels.shard_merge import shard_merge
    from cruise_control_torch.parallel import sharding, spmd

    dims, sg, ag = pair["dims"], pair["sg"], pair["ag"]
    mesh = sharding.make_mesh(4, devices=["cuda:0"] * 4)
    p = dims.num_partitions - dims.num_partitions % 4
    cut = dataclasses.replace(dims, num_partitions=p)
    st = sg._replace(part_load=sg.part_load[:p], topic_id=sg.topic_id[:p],
                     movable_partition=sg.movable_partition[:p])
    agg = ag._replace(assignment=ag.assignment[:p], rack_replica_count=ag.rack_replica_count[:p],
                      touch_tag=ag.touch_tag[:p])
    placed = sharding.place_static(st, mesh)
    goals = goals_by_priority(None)
    for gi in (2, 13):
        g = goals[gi]
        tables = build_tables(goals[:gi], st, agg, cut)
        gs = g.prepare(st, agg, cut)
        cands = opt.dst_candidates(st, gs, agg, g, cut, 4, tables)
        shortlist = spmd.make_grid_shortlist(mesh, g, cut, opt.GREEDY_SETTINGS)
        k9, k12 = grid_shortlist.launches, shard_merge.launches
        got = shortlist(placed, agg, gs, tables, cands)
        torch.cuda.synchronize()
        assert (grid_shortlist.launches - k9, shard_merge.launches - k12) == (4, 1)
        for want in (grid_shortlist(st, agg, tables, g, gs, cands),
                     shortlist.plain(placed, agg, gs, tables, cands)):
            for w, x in zip(want, got):
                assert _bits(w, x), (g.name, want, got)
    k13 = partition_stats.launches
    counts = spmd.make_partition_stats(mesh)(placed, agg)
    assert partition_stats.launches - k13 == 4
    assert [int(c) for c in counts] == [int(st.movable_partition.sum()),
                                        int((agg.assignment >= 0).sum()), p]


def test_greedy_on_a_mesh_of_the_card_equals_the_cpu():
    """The bench's greedy pass on fixture C through a mesh of 4 shards of
    the card equals the same run on a mesh of 4 shards of the CPU (766
    partitions padded to 768 on both), K9 launched 4 times a grid round and
    K12 once."""
    _card()
    from cruise_control_torch import kernels
    from cruise_control_torch.parallel.sharding import make_mesh

    model = generators.random_cluster(42, FIXTURE_C)
    cpu = opt.GoalOptimizer(settings=opt.GREEDY_SETTINGS,
                            mesh=make_mesh(4, devices=["cpu"] * 4)).optimizations(
        model, None, raise_on_hard_failure=False)
    kernels.reset_launches()
    card = opt.GoalOptimizer(settings=opt.GREEDY_SETTINGS,
                             mesh=make_mesh(4, devices=["cuda:0"] * 4)).optimizations(
        model, None, raise_on_hard_failure=False)
    launched = kernels.launches()
    assert launched["shard_merge"] > 0
    assert launched["grid_shortlist"] == 4 * launched["shard_merge"]
    names = [g.name for g in cpu.goal_results]
    assert np.array_equal(cpu.final_assignment, card.final_assignment)
    assert np.array_equal(cpu.touch_tag, card.touch_tag)
    assert cpu.provenance.digest(goals=names) == card.provenance.digest(goals=names)
