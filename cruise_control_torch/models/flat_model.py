"""FlatClusterModel: the cluster workload model as a tuple of tensors.

The same dense layout as the JAX package's model:

  assignment : i32[P, R]  broker index per replica slot; slot 0 is the leader;
                          -1 marks an unused (padded) slot.
  part_load  : f32[P, M]  per-partition expected utilization per PartMetric.
  topic_id   : i32[P]     topic of each partition.
  broker_capacity : f32[B, 4]  capacity per Resource.
  broker_rack / broker_host : i32[B]
  broker_state : i32[B]   BrokerState (ALIVE/NEW/DEMOTED/DEAD).

Every tensor lives on one device; `to(device)` moves the whole model. The
masks and segment helpers (`broker_loads`, `replica_counts`, `host_loads`,
`utilization_matrix`, ...) are the JAX model's (models/flat_model.py
:96-246) with its names, arguments and dtypes; their float sums come from
K1 (kernels.segment_aggregates) on the model's assignment, or add in
ascending broker order from +0.0 (the host sums), the order of XLA:CPU's
segment_sum.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import numpy as np
import torch

from cruise_control_torch.common.resources import BrokerState, PartMetric, Resource

_DTYPES = {
    "assignment": torch.int32,
    "part_load": torch.float32,
    "topic_id": torch.int32,
    "broker_capacity": torch.float32,
    "broker_rack": torch.int32,
    "broker_host": torch.int32,
    "broker_state": torch.int32,
}


class FlatClusterModel(NamedTuple):
    assignment: torch.Tensor  # i32[P, R]
    part_load: torch.Tensor  # f32[P, M]
    topic_id: torch.Tensor  # i32[P]
    broker_capacity: torch.Tensor  # f32[B, 4]
    broker_rack: torch.Tensor  # i32[B]
    broker_host: torch.Tensor  # i32[B]
    broker_state: torch.Tensor  # i32[B]

    @property
    def num_partitions(self) -> int:
        return self.assignment.shape[0]

    @property
    def max_replication_factor(self) -> int:
        return self.assignment.shape[1]

    @property
    def num_brokers(self) -> int:
        return self.broker_capacity.shape[0]

    @property
    def num_topics(self) -> int:
        # topic ids are dense [0, T)
        # cclint: disable=cuda-host-sync,cuda-shape-branch -- Dims are host ints, read once per prepared model
        return int(self.topic_id.max()) + 1 if self.topic_id.shape[0] else 0

    @property
    def device(self) -> torch.device:
        return self.assignment.device

    def to(self, device) -> "FlatClusterModel":
        return FlatClusterModel(*(t.to(device) for t in self))


@dataclasses.dataclass(frozen=True, eq=False)
class ClusterMetadata:
    """Host-side naming metadata kept beside the model's tensors (the JAX
    model's :71).

    eq=False: ndarray fields make the generated __eq__ ambiguous; identity
    comparison is the meaningful one for a metadata handle.
    """

    topic_names: tuple
    partition_index: np.ndarray  # i32[P] partition number within its topic
    broker_ids: np.ndarray  # i32[B] external broker ids
    rack_names: tuple = ()
    host_names: tuple = ()
    topic_of_partition: np.ndarray = None  # i32[P]

    def topic_partition(self, p: int) -> str:
        """Render partition p as 'topic-partitionIndex' for proposals/REST."""
        if self.topic_of_partition is None:
            raise ValueError("ClusterMetadata built without topic_of_partition")
        # cclint: disable=cuda-host-sync -- host helper (model construction, names, host copies): never runs inside a round
        t = int(self.topic_of_partition[p])
        # cclint: disable=cuda-host-sync -- host helper (model construction, names, host copies): never runs inside a round
        return f"{self.topic_names[t]}-{int(self.partition_index[p])}"


# -- masks and segment helpers (the JAX model's :96-246) -------------------------


def valid_slot_mask(model: FlatClusterModel) -> torch.Tensor:
    """bool[P, R]: which replica slots are populated."""
    return model.assignment >= 0


def replication_factor(model: FlatClusterModel) -> torch.Tensor:
    """i32[P]: replicas per partition."""
    return torch.sum(valid_slot_mask(model), dim=1, dtype=torch.int32)


def alive_broker_mask(model: FlatClusterModel) -> torch.Tensor:
    """bool[B]: brokers that can receive replicas (not DEAD)."""
    return model.broker_state != BrokerState.DEAD


def new_broker_mask(model: FlatClusterModel) -> torch.Tensor:
    return model.broker_state == BrokerState.NEW


def dead_broker_mask(model: FlatClusterModel) -> torch.Tensor:
    return model.broker_state == BrokerState.DEAD


def leader_contribution(part_load: torch.Tensor) -> torch.Tensor:
    """f32[..., 4]: per-Resource load a partition places on its leader broker
    (`part_load` f32[..., M]). Exact column selection (no matmul)."""
    return torch.stack(
        [
            part_load[..., PartMetric.CPU_LEADER],
            part_load[..., PartMetric.NW_IN_LEADER],
            part_load[..., PartMetric.NW_OUT_LEADER],
            part_load[..., PartMetric.DISK],
        ],
        dim=-1,
    )


def follower_contribution(part_load: torch.Tensor) -> torch.Tensor:
    """f32[..., 4]: per-Resource load a partition places on each follower broker."""
    return torch.stack(
        [
            part_load[..., PartMetric.CPU_FOLLOWER],
            part_load[..., PartMetric.NW_IN_FOLLOWER],
            torch.zeros_like(part_load[..., 0]),
            part_load[..., PartMetric.DISK],
        ],
        dim=-1,
    )


def _segment_ids(model: FlatClusterModel) -> torch.Tensor:
    """i32[P, R]: broker id per slot, with empty slots routed to bucket B."""
    return torch.where(valid_slot_mask(model), model.assignment, model.num_brokers)


def segment_sums(model: FlatClusterModel, num_topics: int):
    """K1's outputs for the model's assignment (kernels.segment_aggregates):
    (broker_load, replica_count, leader_count, potential_nw_out,
    leader_nw_in, rack_replica_count, topic_replica_count, host_cpu_load).
    Each broker's slots are summed in ascending slot order, the order of
    XLA:CPU's segment_sum."""
    from cruise_control_torch.kernels.segment_aggregates import segment_aggregates

    # cclint: disable=cuda-host-sync -- the rack and host counts, read once a statistics call, outside the rounds
    num_racks = int(model.broker_rack.max()) + 1 if model.num_brokers else 0
    # cclint: disable=cuda-host-sync -- the rack and host counts, read once a statistics call, outside the rounds
    num_hosts = int(model.broker_host.max()) + 1 if model.num_brokers else 0
    return segment_aggregates(model.assignment, model.part_load, model.topic_id,
                              model.broker_rack, model.broker_host, model.num_brokers,
                              num_racks, num_hosts, num_topics)


def broker_loads(model: FlatClusterModel) -> torch.Tensor:
    """f32[B, 4]: per-broker load per Resource."""
    return segment_sums(model, model.num_topics)[0]


def replica_counts(model: FlatClusterModel) -> torch.Tensor:
    """i32[B]: replicas per broker."""
    return segment_sums(model, model.num_topics)[1]


def leader_counts(model: FlatClusterModel) -> torch.Tensor:
    """i32[B]: leader replicas per broker."""
    return segment_sums(model, model.num_topics)[2]


def potential_nw_out(model: FlatClusterModel) -> torch.Tensor:
    """f32[B]: NW_OUT each broker would carry if every replica it hosts led."""
    return segment_sums(model, model.num_topics)[3]


def topic_replica_counts(model: FlatClusterModel, num_topics: int) -> torch.Tensor:
    """i32[T, B]: replicas of each topic on each broker."""
    return segment_sums(model, num_topics)[6]


def _host_sum(values: torch.Tensor, broker_host: torch.Tensor, num_hosts: int) -> torch.Tensor:
    """f32[H, ...]: `values` f32[B, ...] summed over each host's brokers, in
    ascending broker order from +0.0 (XLA:CPU's segment_sum; a broker whose
    host is outside [0, H) is dropped, as its scatter drops it). The brokers
    are sorted stably by host into a [H, m] table, m the most brokers a host
    has, and its m columns are added left to right: elementwise adds, no
    atomics, the same order on the CPU and on the card. Empty places add
    +0.0, which changes no sum that starts at +0.0."""
    dev, b = values.device, values.shape[0]
    # brokers of no host go to bucket H, the table's last row, which is cut
    h = torch.where((broker_host >= 0) & (broker_host < num_hosts), broker_host, num_hosts).long()
    order = torch.argsort(h, stable=True)
    hs = h[order]
    counts = torch.bincount(h, minlength=num_hosts + 1)
    # cclint: disable=cuda-host-sync -- the table's width, read once a call of a host helper that runs on no round
    m = int(counts[:num_hosts].max()) if num_hosts and b else 0
    col = torch.arange(b, device=dev) - (torch.cumsum(counts, 0) - counts)[hs]
    table = torch.zeros((num_hosts + 1, m + 1) + tuple(values.shape[1:]), dtype=values.dtype,
                        device=dev)
    table[hs, torch.clamp(col, max=m)] = values[order]
    out = torch.zeros((num_hosts,) + tuple(values.shape[1:]), dtype=values.dtype, device=dev)
    for c in range(m):
        out = out + table[:num_hosts, c]
    return out


def host_loads(model: FlatClusterModel, num_hosts: int) -> torch.Tensor:
    """f32[H, 4]: broker loads aggregated per host (CPU capacity is host-level);
    its CPU column equals K1's host_cpu_load bit for bit."""
    return _host_sum(broker_loads(model), model.broker_host, num_hosts)


def host_capacity(model: FlatClusterModel, num_hosts: int) -> torch.Tensor:
    """f32[H, 4]: per-host capacity = sum of its brokers' capacities."""
    return _host_sum(model.broker_capacity, model.broker_host, num_hosts)


def utilization_matrix(model: FlatClusterModel) -> torch.Tensor:
    """f32[7, B]: derived-resource x broker matrix over RawAndDerivedResource
    (DISK, CPU, LEADER_NW_IN, FOLLOWER_NW_IN, NW_OUT, PWN_NW_OUT, REPLICAS),
    as ClusterModel.utilizationMatrix (cc/model/ClusterModel.java:1113).

    Each row is a K1 output that adds the JAX function's terms in its order:
    DISK, CPU and NW_OUT are broker_load's columns, LEADER_NW_IN leader_nw_in
    (the JAX sum's +0.0 at follower slots changes no sum from +0.0),
    PWN_NW_OUT potential_nw_out, REPLICAS replica_count as f32 (exact below
    2**24). FOLLOWER_NW_IN is the NW_IN column of a second K1 call whose
    part_load has its NW_IN_LEADER column zeroed: leader slots then add the
    same +0.0 that the JAX function's `where` puts there."""
    t = model.num_topics
    load, replicas, _, pwn, leader_nw_in = segment_sums(model, t)[:5]
    no_leader_in = model.part_load.clone()
    no_leader_in[:, PartMetric.NW_IN_LEADER] = 0.0
    follower_nw_in = segment_sums(model._replace(part_load=no_leader_in), t)[0][:, Resource.NW_IN]
    return torch.stack([load[:, Resource.DISK], load[:, Resource.CPU], leader_nw_in,
                        follower_nw_in, load[:, Resource.NW_OUT], pwn,
                        replicas.to(torch.float32)])


# -- single-action edits (the JAX model's :271-312) -----------------------------
# Each returns a new model whose assignment is a copy with the edit made; the
# model given is not changed (the JAX model's `.at[].set` on an immutable
# array).


def relocate_replica(model: FlatClusterModel, p, slot, dst_broker) -> FlatClusterModel:
    """Move the replica in (partition p, slot) to dst_broker; leadership stays
    with the slot, so moving slot 0 moves the leadership load too."""
    a = model.assignment.clone()
    a[p, slot] = dst_broker
    return model._replace(assignment=a)


def relocate_leadership(model: FlatClusterModel, p, slot) -> FlatClusterModel:
    """Make the replica in (p, slot) the leader by swapping slots 0 and slot."""
    a = model.assignment.clone()
    old_leader, new_leader = a[p, 0].clone(), a[p, slot].clone()
    a[p, 0] = new_leader
    a[p, slot] = old_leader
    return model._replace(assignment=a)


def swap_replicas(model: FlatClusterModel, p1, slot1, p2, slot2) -> FlatClusterModel:
    """Swap the brokers of (p1, slot1) and (p2, slot2)."""
    a = model.assignment.clone()
    b1, b2 = a[p1, slot1].clone(), a[p2, slot2].clone()
    a[p1, slot1] = b2
    a[p2, slot2] = b1
    return model._replace(assignment=a)


def from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> FlatClusterModel:
    """Build the port's model from the JAX model's fields as numpy arrays,
    e.g. `{k: np.asarray(v) for k, v in jax_model._asdict().items()}`.
    Values are copied; dtypes are the JAX model's (int32 / float32)."""
    return FlatClusterModel(
        **{
            # cclint: disable=cuda-host-sync -- host helper (model construction, names, host copies): never runs inside a round
            name: torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
            for name, dtype in _DTYPES.items()
        }
    )


def to_numpy(model: FlatClusterModel) -> dict:
    """The model's fields as numpy arrays (the inverse of `from_numpy`)."""
    # cclint: disable=cuda-host-sync -- host helper (model construction, names, host copies): never runs inside a round
    return {k: v.cpu().numpy() for k, v in model._asdict().items()}


def sanity_check(model: FlatClusterModel) -> None:
    """Invariant checker, the analog of ClusterModel.sanityCheck
    (cc/model/ClusterModel.java:918). Host-side; raises on violation."""
    # cclint: disable=cuda-host-sync -- host helper (model construction, names, host copies): never runs inside a round
    a = model.assignment.cpu().numpy()
    b = model.num_brokers
    valid = a >= 0
    if not valid[:, 0].all():
        raise ValueError("every partition must have a leader in slot 0")
    if (a >= b).any():
        raise ValueError("assignment references nonexistent broker")
    # no partition may have two replicas on one broker
    p, r = a.shape
    masked = np.where(valid, a, -np.arange(p * r).reshape(p, r) - 1)
    sorted_rows = np.sort(masked, axis=1)
    if (sorted_rows[:, 1:] == sorted_rows[:, :-1]).any():
        raise ValueError("partition has two replicas on the same broker")
    # valid slots must be left-packed so RF == count of leading valid slots
    first_invalid = np.argmin(valid, axis=1)
    rf = valid.sum(axis=1)
    packed = (rf == r) | (first_invalid == rf)
    if not packed.all():
        raise ValueError("replica slots must be left-packed")
    # cclint: disable=cuda-host-sync -- host helper (model construction, names, host copies): never runs inside a round
    load = model.part_load.cpu().numpy()
    if (load < 0).any() or not np.isfinite(load).all():
        raise ValueError("partition loads must be finite and non-negative")
    if model.broker_rack.shape[0] != b or model.broker_host.shape[0] != b:
        raise ValueError("broker attribute arrays disagree on broker count")
