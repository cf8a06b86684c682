"""The cluster statistics and the state fingerprint against the JAX package
(CPU): the segment helpers (models/flat_model.py :96-246) exactly, K8's plain
version through `compute_stats` bit-equal to the jitted `compute_stats`, and
K7's plain version equal to the jitted `_state_fingerprint`, on fixture C
(32 brokers, 80 topics) and on a 100-broker cluster (BASELINE config 2 with
pareto load and 2 dead brokers, 500 topics), where every float sum runs past
XLA's 32-term window.
"""

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.optimizer import _state_fingerprint
from cruise_control_tpu.analyzer.stats import compute_stats as jstats
from cruise_control_tpu.analyzer.stats import stats_to_dict as jstats_to_dict
from cruise_control_tpu.models import flat_model as jfm
from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.analyzer.stats import compute_stats, stats_to_dict, stats_to_host
from cruise_control_torch.kernels.cluster_stats import cluster_stats_plain
from cruise_control_torch.kernels.state_fingerprint import state_fingerprint
from cruise_control_torch.models import flat_model as tfm

FIXTURE_C = jgen.ClusterProperty(num_racks=4, num_brokers=32, num_topics=80,
                                 mean_partitions_per_topic=10, replication_factor=3,
                                 num_dead_brokers=2, load_distribution="pareto",
                                 mean_utilization=0.5)
MODEL_100 = dataclasses.replace(jgen.BASELINE_CONFIGS[2], num_dead_brokers=2,
                                load_distribution="pareto", mean_utilization=0.5)
MODELS = {"fixture_c": FIXTURE_C, "brokers_100": MODEL_100}
HELPERS = ("valid_slot_mask", "alive_broker_mask", "_segment_ids", "broker_loads",
           "replica_counts", "leader_counts", "potential_nw_out", "topic_replica_counts")

_jit_stats = jax.jit(jstats, static_argnums=1)
_jit_fp = jax.jit(_state_fingerprint)
_FpAgg = collections.namedtuple("_FpAgg", "broker_load leader_nw_in leader_count replica_count")


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32 and b.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module", params=list(MODELS))
def models(request):
    m = jgen.random_cluster(42, MODELS[request.param])
    tm = tfm.from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})
    return m, tm, int(np.asarray(m.topic_id).max()) + 1


@pytest.mark.parametrize("helper", HELPERS)
def test_segment_helpers_equal_jax(models, helper):
    m, tm, t = models
    args = (t,) if helper == "topic_replica_counts" else ()
    j = jax.jit(getattr(jfm, helper), static_argnums=(1,) if args else ())(m, *args)
    assert _same(j, getattr(tfm, helper)(tm, *args).numpy())


def test_compute_stats_equals_jitted_jax(models):
    m, tm, t = models
    j = jax.device_get(_jit_stats(m, t))
    p = stats_to_host(compute_stats(tm, t))
    for field in j._fields:
        assert _same(getattr(j, field), getattr(p, field)), field
    assert stats_to_dict(p) == jstats_to_dict(j)


def test_compute_stats_of_a_moved_assignment(models):
    # stats_after's input: the same model with leaders swapped and followers
    # moved to random brokers
    m, tm, t = models
    rng = np.random.default_rng(3)
    a = np.asarray(m.assignment).copy()
    rows = rng.choice(a.shape[0], a.shape[0] // 2, replace=False)
    a[rows[::2]] = a[rows[::2]][:, ::-1]
    a[rows[1::2], 1] = rng.integers(0, m.num_brokers, rows[1::2].shape[0])
    m2 = m._replace(assignment=a)
    j = jax.device_get(_jit_stats(m2, t))
    p = stats_to_host(compute_stats(tm._replace(assignment=torch.from_numpy(a)), t))
    for field in j._fields:
        assert _same(getattr(j, field), getattr(p, field)), field


def test_cluster_stats_with_every_broker_dead_and_an_empty_topic():
    rng = np.random.default_rng(5)
    b, t = 40, 6
    load = rng.pareto(1.5, (b, 4)).astype(np.float32)
    cap = np.full((b, 4), 100.0, dtype=np.float32)
    counts = rng.integers(0, 4, (t, b)).astype(np.int32)
    counts[2] = 0
    reps = counts.sum(0).astype(np.int32)
    out, out_i = cluster_stats_plain(*(torch.from_numpy(x) for x in (
        load, cap, np.zeros(b, bool), reps, reps // 2, load[:, 2].copy(), counts)))
    assert out_i.tolist() == [0, int(reps.sum()), int((reps // 2).sum())]
    # no alive broker: means 0 over max(0, 1), min +inf, max -inf
    assert out[0].item() == 0.0 and out[8].item() == np.inf and out[12].item() == -np.inf
    assert out[20].item() == 0.0  # topic spread: no alive broker, std 0


def _fp_inputs(rng, b):
    return dict(broker_load=(rng.pareto(1.5, (b, 4)) * rng.choice([-1, 1], (b, 4))).astype(np.float32),
                leader_nw_in=rng.pareto(1.5, b).astype(np.float32),
                leader_count=rng.integers(-5, 2 ** 31 - 1, b).astype(np.int32),
                replica_count=rng.integers(0, 300, b).astype(np.int32))


def _port_fp(a):
    return int(state_fingerprint(_FpAgg(**{k: torch.from_numpy(v) for k, v in a.items()})))


@pytest.mark.parametrize("b", (1, 32, 100, 2600))
def test_state_fingerprint_equals_jax(b):
    a = _fp_inputs(np.random.default_rng(b), b)
    a["broker_load"][0, 1] = -0.0
    assert _port_fp(a) == int(_jit_fp(_FpAgg(**a)))


def test_state_fingerprint_sees_a_sign_flip():
    a = _fp_inputs(np.random.default_rng(9), 100)
    a["broker_load"][3, 2] = 0.0
    b = {k: v.copy() for k, v in a.items()}
    b["broker_load"][3, 2] = -0.0
    fa, fb = _port_fp(a), _port_fp(b)
    assert fa != fb
    assert (fa, fb) == (int(_jit_fp(_FpAgg(**a))), int(_jit_fp(_FpAgg(**b))))


def _crafted_counts_model(t: int, b: int, seed: int) -> dict:
    """Fields of a model whose [t, b] topic table is random, with a random
    count range per topic, about a tenth of the brokers dead and of the
    topics empty: the per-topic deviations take many values of many
    magnitudes (half the topics have one broker with hundreds or thousands of
replicas). RF 1, padded to a fixed 131,072 partitions with empty rows,
    so every seed of one (t, b) shares one jitted program."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, rng.integers(2, 24, (t, 1)) + 1, (t, b))
    heavy = np.nonzero(rng.random(t) < 0.5)[0]
    counts[heavy, rng.integers(0, b, heavy.size)] += rng.integers(100, 3000, heavy.size)
    counts[rng.random(t) < 0.1] = 0
    t_idx, b_idx = np.nonzero(counts)
    reps = counts[t_idx, b_idx]
    p = 131072
    topic = np.repeat(t_idx, reps).astype(np.int32)
    broker = np.repeat(b_idx, reps).astype(np.int32)
    state = np.where(rng.random(b) < 0.1, 3, 0).astype(np.int32)
    return dict(assignment=np.concatenate([broker, np.full(p - topic.size, -1, np.int32)])[:, None],
                part_load=np.ones((p, 8), np.float32),
                topic_id=np.concatenate([topic, np.zeros(p - topic.size, np.int32)]),
                broker_capacity=np.ones((b, 4), np.float32),
                broker_rack=(np.arange(b) % 3).astype(np.int32),
                broker_host=np.arange(b, dtype=np.int32), broker_state=state)


def _lane_sum(values, lanes: int):
    """The topics' sum with `lanes` vector lanes added by halves and the
    rest one by one (0: index order). `values` may hold float32 numbers, or
    names, when the result is the order's expression tree (an add of +0.0
    first drops out)."""

    def add(x, y):
        if x is None:
            return y
        return np.float32(x + y) if isinstance(x, np.float32) else (x, y)

    t = len(values)
    acc = [None] * max(lanes, 1)
    main = t - t % lanes if lanes else 0
    for i in range(main):
        acc[i % lanes] = add(acc[i % lanes], values[i])
    while len(acc) > 1:
        h = len(acc) // 2
        acc = [add(acc[j], acc[j + h]) for j in range(h)]
    s = acc[0]
    for i in range(main, t):
        s = add(s, values[i])
    return s


def _window_tree(t: int):
    """The expression tree of xla_sum over t names."""
    if t <= 32:
        return _lane_sum(list(range(t)), 0)
    m = -(-t // 32) * 32
    names = [None] * ((m - t) // 2) + list(range(t)) + [None] * (m - t - (m - t) // 2)
    windows = [_lane_sum([x for x in names[w:w + 32] if x is not None], 0)
               for w in range(0, m, 32)]
    return _lane_sum(windows, 0)


@pytest.mark.parametrize("b", (32, 70))
@pytest.mark.parametrize("t", (1, 7, 20, 32, 33))
def test_topic_spread_equals_jitted_jax_in_its_own_order(t, b, monkeypatch):
    # K8's mean over the topics: at t <= 32 in the vectorized order XLA:CPU
    # compiles (TOPIC_LANES), above in windows of 32. Eight crafted tables
    # per shape: the port equals jitted JAX on each, and every other order
    # among index order, 2, 4, 8 or 16 lanes and windows misses on at least
    # one of them
    from cruise_control_torch.kernels import cluster_stats as k8

    inner, seen = k8.topic_order_sum, []
    monkeypatch.setattr(k8, "topic_order_sum",
                        lambda v, nb: seen.append(v.numpy().copy()) or inner(v, nb))
    lanes = k8.TOPIC_LANES[b > 32][t - 1] if t <= 32 else None
    truth_tree = _window_tree(t) if lanes is None else _lane_sum(list(range(t)), lanes)
    others = {tree: name for name, tree in (
        [(f"{n} lanes", _lane_sum(list(range(t)), n)) for n in (0, 2, 4, 8, 16)]
        + [("windows", _window_tree(t))]) if tree != truth_tree}
    missed = set()
    for seed in range(8):
        f = _crafted_counts_model(t, b, seed)
        j = jax.device_get(_jit_stats(jfm.FlatClusterModel(**f), t)).topic_replica_std
        p = stats_to_host(compute_stats(tfm.from_numpy(f), t)).topic_replica_std
        assert _same(j, p), seed
        v = seen[-1]
        truth = k8.topic_sum(v, b)
        assert _same(inner(torch.from_numpy(v), b), truth), seed
        for name in others.values():
            alt = k8.xla_sum(v) if name == "windows" else _lane_sum(
                [np.float32(x) for x in v], int(name.split()[0]))
            if not _same(alt, truth):
                missed.add(name)
    assert missed == set(others.values()), sorted(set(others.values()) - missed)
    assert t > 1 or not others
