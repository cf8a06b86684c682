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
segment helpers (`broker_loads`, `replica_counts`, ...) are the JAX model's
(models/flat_model.py :96-246); their sums come from K1
(kernels.segment_aggregates) on the model's assignment.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import numpy as np
import torch

from cruise_control_torch.common.resources import BrokerState

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
        t = int(self.topic_of_partition[p])
        return f"{self.topic_names[t]}-{int(self.partition_index[p])}"


# -- masks and segment helpers (the JAX model's :96-246) -------------------------


def valid_slot_mask(model: FlatClusterModel) -> torch.Tensor:
    """bool[P, R]: which replica slots are populated."""
    return model.assignment >= 0


def alive_broker_mask(model: FlatClusterModel) -> torch.Tensor:
    """bool[B]: brokers that can receive replicas (not DEAD)."""
    return model.broker_state != BrokerState.DEAD


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

    num_racks = int(model.broker_rack.max()) + 1 if model.num_brokers else 0
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
            name: torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
            for name, dtype in _DTYPES.items()
        }
    )


def to_numpy(model: FlatClusterModel) -> dict:
    """The model's fields as numpy arrays (the inverse of `from_numpy`)."""
    return {k: v.cpu().numpy() for k, v in model._asdict().items()}


def sanity_check(model: FlatClusterModel) -> None:
    """Invariant checker, the analog of ClusterModel.sanityCheck
    (cc/model/ClusterModel.java:918). Host-side; raises on violation."""
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
    load = model.part_load.cpu().numpy()
    if (load < 0).any() or not np.isfinite(load).all():
        raise ValueError("partition loads must be finite and non-negative")
    if model.broker_rack.shape[0] != b or model.broker_host.shape[0] != b:
        raise ValueError("broker attribute arrays disagree on broker count")
