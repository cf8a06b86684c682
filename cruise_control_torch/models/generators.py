"""Synthetic cluster model generators (test fixtures + benchmark inputs).

The counterparts of the reference's test fixture tiers (SURVEY.md §4):
`DeterministicCluster` (cct/common/DeterministicCluster.java:22 — tiny
hand-built models with known optimizer outcomes) and `RandomCluster`
(cct/model/RandomCluster.java:33 — seeded random models swept to ~80k
replicas). Everything is pure NumPy and vectorized so the 2.6k-broker /
200k-partition benchmark config generates in seconds. `make_model` wraps the
arrays as the port's model on the CPU; move it with `model.to(device)`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from cruise_control_torch.common.resources import (
    NUM_PART_METRICS,
    NUM_RESOURCES,
    BrokerState,
    PartMetric,
    Resource,
)
from cruise_control_torch.models.flat_model import ClusterMetadata, FlatClusterModel, from_numpy


def make_model(
    assignment: np.ndarray,
    part_load: np.ndarray,
    topic_id: np.ndarray,
    broker_capacity: np.ndarray,
    broker_rack: np.ndarray,
    broker_host: Optional[np.ndarray] = None,
    broker_state: Optional[np.ndarray] = None,
) -> FlatClusterModel:
    b = broker_capacity.shape[0]
    if broker_host is None:
        broker_host = np.arange(b, dtype=np.int32)  # one broker per host
    if broker_state is None:
        broker_state = np.full(b, BrokerState.ALIVE, dtype=np.int32)
    return from_numpy(
        dict(
            assignment=np.asarray(assignment, dtype=np.int32),
            part_load=np.asarray(part_load, dtype=np.float32),
            topic_id=np.asarray(topic_id, dtype=np.int32),
            broker_capacity=np.asarray(broker_capacity, dtype=np.float32),
            broker_rack=np.asarray(broker_rack, dtype=np.int32),
            broker_host=np.asarray(broker_host, dtype=np.int32),
            broker_state=np.asarray(broker_state, dtype=np.int32),
        )
    )


def _part_load(
    cpu_leader, nw_in_leader, nw_out_leader, disk, follower_cpu_ratio=0.5
) -> np.ndarray:
    """Assemble a part_load matrix from leader-side rates.

    Follower NW_IN equals leader NW_IN (replication pulls everything the leader
    ingests) and follower CPU is a fixed fraction of leader CPU — the shape of
    ModelUtils.getFollowerCpuUtilFromLeaderLoad (cc/model/ModelUtils.java:42).
    """
    p = len(cpu_leader)
    load = np.zeros((p, NUM_PART_METRICS), dtype=np.float32)
    load[:, PartMetric.CPU_LEADER] = cpu_leader
    load[:, PartMetric.CPU_FOLLOWER] = np.asarray(cpu_leader) * follower_cpu_ratio
    load[:, PartMetric.NW_IN_LEADER] = nw_in_leader
    load[:, PartMetric.NW_IN_FOLLOWER] = nw_in_leader
    load[:, PartMetric.NW_OUT_LEADER] = nw_out_leader
    load[:, PartMetric.DISK] = disk
    return load


def _uniform_capacity(num_brokers: int, cpu=100.0, nw_in=1e5, nw_out=1e5, disk=1e6) -> np.ndarray:
    cap = np.zeros((num_brokers, NUM_RESOURCES), dtype=np.float32)
    cap[:, Resource.CPU] = cpu
    cap[:, Resource.NW_IN] = nw_in
    cap[:, Resource.NW_OUT] = nw_out
    cap[:, Resource.DISK] = disk
    return cap


# -- deterministic fixtures (tier 1) ------------------------------------------


def unbalanced() -> FlatClusterModel:
    """3 brokers / 3 racks, all load piled on broker 0.

    Analog of DeterministicCluster.unbalanced (cct/common/DeterministicCluster.java:97):
    distribution goals must move replicas/leadership off broker 0; rack-aware
    and capacity goals are satisfiable.
    """
    # topics: T0 with 2 partitions RF2, T1 with 2 partitions RF2
    assignment = np.array(
        [[0, 1], [0, 1], [0, 2], [0, 2]], dtype=np.int32
    )
    topic_id = np.array([0, 0, 1, 1], dtype=np.int32)
    load = _part_load(
        cpu_leader=[20.0, 20.0, 20.0, 20.0],
        nw_in_leader=[8000.0, 8000.0, 8000.0, 8000.0],
        nw_out_leader=[9000.0, 9000.0, 9000.0, 9000.0],
        disk=[1.0e5, 1.0e5, 1.0e5, 1.0e5],
    )
    return make_model(
        assignment, load, topic_id,
        _uniform_capacity(3), broker_rack=np.array([0, 1, 2], dtype=np.int32),
    )


def rack_aware_violated() -> FlatClusterModel:
    """4 brokers on 2 racks; partition 0 has both replicas on rack 0.

    Analog of DeterministicCluster.rackAwareSatisfiable
    (cct/common/DeterministicCluster.java:122): one replica move to rack 1
    satisfies RackAwareGoal.
    """
    assignment = np.array([[0, 1], [0, 2], [2, 1]], dtype=np.int32)
    topic_id = np.array([0, 0, 1], dtype=np.int32)
    rack = np.array([0, 0, 1, 1], dtype=np.int32)
    load = _part_load(
        cpu_leader=[5.0, 5.0, 5.0],
        nw_in_leader=[100.0, 100.0, 100.0],
        nw_out_leader=[100.0, 100.0, 100.0],
        disk=[100.0, 100.0, 100.0],
    )
    return make_model(assignment, load, topic_id, _uniform_capacity(4), rack)


def capacity_violated() -> FlatClusterModel:
    """Broker 0 over its NW_IN capacity threshold; others nearly idle."""
    assignment = np.array([[0, 1], [0, 2], [0, 3], [0, 1]], dtype=np.int32)
    topic_id = np.array([0, 0, 0, 1], dtype=np.int32)
    rack = np.array([0, 1, 2, 3], dtype=np.int32)
    cap = _uniform_capacity(4, nw_in=1000.0)
    # leader NW_IN totals 900 on broker 0 > 0.8 * 1000 capacity threshold
    load = _part_load(
        cpu_leader=[5.0, 5.0, 5.0, 5.0],
        nw_in_leader=[225.0, 225.0, 225.0, 225.0],
        nw_out_leader=[50.0, 50.0, 50.0, 50.0],
        disk=[100.0, 100.0, 100.0, 100.0],
    )
    return make_model(assignment, load, topic_id, cap, rack)


def dead_broker_model() -> FlatClusterModel:
    """Broker 1 dead; its replicas must be moved off (self-healing mode)."""
    m = unbalanced()
    state = m.broker_state.clone()
    state[1] = BrokerState.DEAD
    return m._replace(broker_state=state)


# -- seeded random generator (tier 2) -----------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterProperty:
    """Analog of the reference's ClusterProperty map (cct/common/TestConstants.java)."""

    num_racks: int = 10
    num_brokers: int = 40
    num_topics: int = 50
    mean_partitions_per_topic: float = 10.0
    replication_factor: int = 2
    #: mean broker utilization as a fraction of capacity, per resource
    mean_utilization: float = 0.35
    #: 'uniform' | 'exponential' | 'linear' | 'pareto' — mirrors the load
    #: distributions in RandomCluster*NewBrokerTest; 'pareto' adds the
    #: hot-partition regime (a handful of partitions dominate the cluster)
    load_distribution: str = "exponential"
    rack_aware_placement: bool = True
    num_dead_brokers: int = 0
    num_new_brokers: int = 0


def _distinct_choice(rng: np.random.Generator, n_rows: int, k: int, n_choices: int) -> np.ndarray:
    """Vectorized sampling of k distinct ints in [0, n_choices) per row."""
    if k > n_choices:
        raise ValueError(f"cannot choose {k} distinct from {n_choices}")
    out = rng.integers(0, n_choices, size=(n_rows, k), dtype=np.int64)
    for _ in range(64):
        s = np.sort(out, axis=1)
        dup_rows = (s[:, 1:] == s[:, :-1]).any(axis=1)
        if not dup_rows.any():
            return out
        out[dup_rows] = rng.integers(0, n_choices, size=(int(dup_rows.sum()), k))
    # tiny remainder: fall back to exact per-row sampling
    for i in np.nonzero((np.sort(out, 1)[:, 1:] == np.sort(out, 1)[:, :-1]).any(1))[0]:
        out[i] = rng.choice(n_choices, size=k, replace=False)
    return out


#: numpy's reduction buffer (`np.getbufsize()`'s default)
_NP_BUFSIZE = 8192


def _pairwise_sum(a: np.ndarray) -> np.float32:
    """numpy's pairwise float32 sum of a 1-D array: eight running sums below
    129 terms, halves (cut at a multiple of 8) above."""
    n = a.shape[0]
    if n < 8:
        res = np.float32(0.0)
        for v in a:
            res = np.float32(res + v)
        return res
    if n <= 128:
        r = a[:8].copy()
        end = n - n % 8
        for i in range(8, end, 8):
            r = r + a[i:i + 8]
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for v in a[end:]:
            res = np.float32(res + v)
        return res
    half = n // 2
    half -= half % 8
    return np.float32(_pairwise_sum(a[:half]) + _pairwise_sum(a[half:]))


def _column_sum(column: np.ndarray) -> np.float32:
    """The float32 sum of a strided column, in one fixed order: numpy 2.0's
    (pairwise within each 8,192-term buffer, the buffers added in order), the
    order the JAX package's generator gets under numpy 2.0. Later numpy
    versions pair over the whole column and round differently, so
    `column.sum()` would give another model on another installation."""
    a = np.ascontiguousarray(column, dtype=np.float32)
    total = None
    for start in range(0, a.shape[0], _NP_BUFSIZE):
        part = _pairwise_sum(a[start:start + _NP_BUFSIZE])
        total = part if total is None else np.float32(total + part)
    return np.float32(0.0) if total is None else total


def random_cluster(
    seed: int, prop: ClusterProperty = ClusterProperty()
) -> FlatClusterModel:
    """Seeded random model; same role as RandomCluster.generate/populate
    (cct/model/RandomCluster.java:45,:81)."""
    rng = np.random.default_rng(seed)
    b, k, rf = prop.num_brokers, prop.num_racks, prop.replication_factor
    rack_of_broker = np.arange(b, dtype=np.int32) % k  # round-robin racks

    # partitions per topic ~ Poisson(mean), at least 1
    parts = np.maximum(1, rng.poisson(prop.mean_partitions_per_topic, size=prop.num_topics))
    topic_id = np.repeat(np.arange(prop.num_topics, dtype=np.int32), parts)
    p = int(parts.sum())

    if prop.rack_aware_placement and rf <= k and b >= k:
        racks = _distinct_choice(rng, p, rf, k)  # [P, RF] distinct racks
        # choose a broker within each rack: brokers of rack r are r, r+k, r+2k...
        per_rack = np.bincount(rack_of_broker, minlength=k)
        slot = rng.integers(0, 1 << 30, size=(p, rf)) % per_rack[racks]
        assignment = (racks + slot * k).astype(np.int32)
    else:
        assignment = _distinct_choice(rng, p, rf, b).astype(np.int32)

    cap = _uniform_capacity(b)
    # target per-broker mean utilization => total load budget per resource
    if prop.load_distribution == "uniform":
        raw = rng.uniform(0.5, 1.5, size=(p, 4))
    elif prop.load_distribution == "linear":
        raw = np.linspace(0.1, 1.9, p)[:, None] * rng.uniform(0.8, 1.2, size=(p, 4))
    elif prop.load_distribution == "pareto":
        # heavy tail: the hottest ~1% of partitions carry a large share of
        # the load (BASELINE config 3's hot-partition regime)
        raw = rng.pareto(1.5, size=(p, 4)) + 0.05
    else:  # exponential: few hot partitions dominate
        raw = rng.exponential(1.0, size=(p, 4))
    raw = raw.astype(np.float32)

    # scale each resource's total so mean broker utilization hits the target.
    # CPU on a broker gets leader + follower shares; NW_IN gets leader+follower;
    # NW_OUT and DISK as modeled in resources.py.
    def budget(res: Resource, replicas: float) -> np.ndarray:
        total = prop.mean_utilization * _column_sum(cap[:, res])
        return total / replicas

    follower_cpu_ratio = 0.5
    cpu_weight = 1.0 + follower_cpu_ratio * (rf - 1)
    cpu_leader = raw[:, 0] / _column_sum(raw[:, 0]) * budget(Resource.CPU, cpu_weight)
    nw_in = raw[:, 1] / _column_sum(raw[:, 1]) * budget(Resource.NW_IN, float(rf))
    # NW_OUT budget is sized against *potential* leadership (every replica
    # counted, PotentialNwOutGoal semantics): leader-only utilization is then
    # mean_utilization/rf and potential utilization is mean_utilization, below
    # the capacity threshold — matching real clusters, where potential NW_OUT
    # is a binding-but-satisfiable constraint. A leader-sized budget would put
    # every broker's potential above the threshold, and a globally-violated
    # PotentialNwOutGoal (faithfully to the reference's actionAcceptance)
    # vetoes every replica move for all downstream goals.
    nw_out = raw[:, 2] / _column_sum(raw[:, 2]) * budget(Resource.NW_OUT, float(rf))
    disk = raw[:, 3] / _column_sum(raw[:, 3]) * budget(Resource.DISK, float(rf))
    load = _part_load(cpu_leader, nw_in, nw_out, disk, follower_cpu_ratio=follower_cpu_ratio)

    state = np.full(b, BrokerState.ALIVE, dtype=np.int32)
    if prop.num_new_brokers:
        state[b - prop.num_new_brokers :] = BrokerState.NEW
    if prop.num_dead_brokers:
        dead = rng.choice(b - prop.num_new_brokers, size=prop.num_dead_brokers, replace=False)
        state[dead] = BrokerState.DEAD

    return make_model(assignment, load, topic_id, cap, rack_of_broker, broker_state=state)


def topic_names(model: FlatClusterModel) -> tuple:
    """The topic names of a generated model, `topic-<t>` for each topic id,
    as the JAX package's `metadata_for` names them (generators.py:281):
    what `resolve_options` matches an excluded-topic pattern against."""
    return tuple(f"topic-{t}" for t in range(model.num_topics))


def metadata_for(model: FlatClusterModel) -> ClusterMetadata:
    """Default naming metadata for generated models (the JAX generators'
    :262): `topic_names(model)`, each partition's index within its topic in
    file order, broker ids 0..B-1."""
    topic_ids = model.topic_id.cpu().numpy()
    # partition index within its topic, in file order (works for any topic-id
    # ordering, grouped or interleaved): stable-sort by topic, rank within the
    # run, scatter the ranks back.
    n = topic_ids.shape[0]
    order = np.argsort(topic_ids, kind="stable")
    sorted_ids = topic_ids[order]
    if n:
        _, first_idx = np.unique(sorted_ids, return_index=True)
        run_id = np.cumsum(np.r_[0, sorted_ids[1:] != sorted_ids[:-1]])
        rank_in_run = np.arange(n) - first_idx[run_id]
    else:
        rank_in_run = np.zeros(0, dtype=np.int64)
    part_index = np.empty(n, dtype=np.int32)
    part_index[order] = rank_in_run.astype(np.int32)
    return ClusterMetadata(
        topic_names=topic_names(model),
        partition_index=part_index,
        broker_ids=np.arange(model.num_brokers, dtype=np.int32),
        topic_of_partition=topic_ids,
    )


# -- benchmark configs (BASELINE.md) ------------------------------------------

BASELINE_CONFIGS = {
    1: ClusterProperty(num_racks=5, num_brokers=20, num_topics=50,
                       mean_partitions_per_topic=20.0, replication_factor=2,
                       rack_aware_placement=False),
    2: ClusterProperty(num_racks=10, num_brokers=100, num_topics=500,
                       mean_partitions_per_topic=20.0, replication_factor=3),
    3: ClusterProperty(num_racks=10, num_brokers=100, num_topics=500,
                       mean_partitions_per_topic=20.0, replication_factor=3,
                       load_distribution="pareto", mean_utilization=0.5),
    4: ClusterProperty(num_racks=10, num_brokers=100, num_topics=500,
                       mean_partitions_per_topic=20.0, replication_factor=3,
                       num_new_brokers=4),
    5: ClusterProperty(num_racks=52, num_brokers=2600, num_topics=4000,
                       mean_partitions_per_topic=50.0, replication_factor=3,
                       load_distribution="exponential"),
}
