"""The four CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and the CUDA toolkit; without one each skips.
They import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest`: the suite's conftest configures JAX.) The inputs are a small
seeded cluster; the full-size comparison is chip_smoke.py's.
"""

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
from cruise_control_torch.kernels.score_candidates import score_candidates, score_candidates_plain
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


@pytest.mark.parametrize("gi", range(6), ids=HARD_GOAL_NAMES)
def test_k3_score_candidates(pair, gi):
    goals = goals_by_priority(HARD_GOAL_NAMES)
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
        if g.name in ("RackAwareGoal", "ReplicaCapacityGoal"):
            assert torch.allclose(sg_[fin], sc_[fin], rtol=1e-6, atol=0.0)
        else:
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
