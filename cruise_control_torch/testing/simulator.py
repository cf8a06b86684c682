"""In-process cluster simulator.

Holds a ground-truth FlatClusterModel and plays every external role the
reference gets from a live Kafka cluster:

- metadata backend for MetadataClient (`fetch_topology`)
- per-broker metric sources for MetricsReporter (`metric_source`), emitting
  the same raw types the in-broker agent produces (byte rates in bytes/s,
  partition sizes in bytes, broker CPU in cumulative util) so the processor's
  unit conversions and CPU attribution are exercised end to end
- cluster mutation surface for the executor (`apply_movement`,
  `apply_leadership`, `kill_broker`, `restore_broker`, `add_broker`) with
  configurable completion latency, standing in for the ZK-reassignment path
  (scala/executor/ExecutorUtils.scala:32)
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np

from cruise_control_torch.common.resources import BrokerState, PartMetric
from cruise_control_torch.models.flat_model import ClusterMetadata, FlatClusterModel, from_numpy
from cruise_control_torch.models.generators import metadata_for
from cruise_control_torch.monitor.metadata import ClusterTopology
from cruise_control_torch.monitor.processor import BYTES_IN_KB, BYTES_IN_MB
from cruise_control_torch.reporter.metrics import (
    BrokerMetric,
    CruiseControlMetric,
    PartitionMetric,
    RawMetricType,
    TopicMetric,
)


class SimulatedCluster:
    def __init__(self, model: FlatClusterModel, metadata: Optional[ClusterMetadata] = None):
        self._lock = threading.RLock()
        self._assignment = np.array(model.assignment.cpu(), dtype=np.int32)
        self._part_load = np.array(model.part_load.cpu(), dtype=np.float32)
        self._topic_id = np.array(model.topic_id.cpu(), dtype=np.int32)
        self._capacity = np.array(model.broker_capacity.cpu(), dtype=np.float32)
        self._rack = np.array(model.broker_rack.cpu(), dtype=np.int32)
        self._host = np.array(model.broker_host.cpu(), dtype=np.int32)
        self._state = np.array(model.broker_state.cpu(), dtype=np.int32)
        self._meta = metadata or metadata_for(model)

    # -- snapshots -------------------------------------------------------------

    def model(self) -> FlatClusterModel:
        """The ground truth as the port's model, on the CPU."""
        with self._lock:
            return from_numpy(dict(
                assignment=self._assignment,
                part_load=self._part_load,
                topic_id=self._topic_id,
                broker_capacity=self._capacity,
                broker_rack=self._rack,
                broker_host=self._host,
                broker_state=self._state,
            ))

    def fetch_topology(self) -> ClusterTopology:
        """Backend for MetadataClient."""
        with self._lock:
            return ClusterTopology(
                topic_names=self._meta.topic_names,
                topic_id=self._topic_id.copy(),
                partition_index=np.asarray(self._meta.partition_index, dtype=np.int32),
                assignment=self._assignment.copy(),
                broker_ids=np.asarray(self._meta.broker_ids, dtype=np.int32),
                broker_rack=self._rack.copy(),
                broker_host=self._host.copy(),
                broker_state=self._state.copy(),
            )

    # -- reporter metric sources -----------------------------------------------

    def metric_source(self, broker_index: int) -> Callable[[int], List[CruiseControlMetric]]:
        """Raw-metric source for one broker's MetricsReporter."""

        def source(now_ms: int) -> List[CruiseControlMetric]:
            with self._lock:
                if self._state[broker_index] == BrokerState.DEAD:
                    return []
                bid = int(self._meta.broker_ids[broker_index])
                a = self._assignment
                pl = self._part_load
                leads = a[:, 0] == broker_index
                follows = (a[:, 1:] == broker_index).any(axis=1)
                out: List[CruiseControlMetric] = []

                cpu = float(
                    pl[leads, PartMetric.CPU_LEADER].sum()
                    + pl[follows, PartMetric.CPU_FOLLOWER].sum()
                )
                bytes_in = float(pl[leads, PartMetric.NW_IN_LEADER].sum()) * BYTES_IN_KB
                bytes_out = float(pl[leads, PartMetric.NW_OUT_LEADER].sum()) * BYTES_IN_KB
                rep_in = float(pl[follows, PartMetric.NW_IN_FOLLOWER].sum()) * BYTES_IN_KB
                # a leader ships NW_IN_FOLLOWER to EACH of its followers
                n_followers = (a[:, 1:] >= 0).sum(axis=1).astype(np.float32)
                rep_out = float(
                    (pl[leads, PartMetric.NW_IN_FOLLOWER] * n_followers[leads]).sum()
                ) * BYTES_IN_KB
                out.append(BrokerMetric(RawMetricType.BROKER_CPU_UTIL, now_ms, bid, cpu))
                out.append(BrokerMetric(RawMetricType.ALL_TOPIC_BYTES_IN, now_ms, bid, bytes_in))
                out.append(BrokerMetric(RawMetricType.ALL_TOPIC_BYTES_OUT, now_ms, bid, bytes_out))
                out.append(
                    BrokerMetric(RawMetricType.ALL_TOPIC_REPLICATION_BYTES_IN, now_ms, bid, rep_in)
                )
                out.append(
                    BrokerMetric(RawMetricType.ALL_TOPIC_REPLICATION_BYTES_OUT, now_ms, bid, rep_out)
                )

                # per-topic IO led by this broker
                led = np.nonzero(leads)[0]
                for t in np.unique(self._topic_id[led]):
                    sel = led[self._topic_id[led] == t]
                    name = self._meta.topic_names[int(t)]
                    t_in = float(pl[sel, PartMetric.NW_IN_LEADER].sum()) * BYTES_IN_KB
                    t_out = float(pl[sel, PartMetric.NW_OUT_LEADER].sum()) * BYTES_IN_KB
                    t_rep_in = float(pl[sel, PartMetric.NW_IN_FOLLOWER].sum()) * BYTES_IN_KB
                    t_rep_out = float(
                        (pl[sel, PartMetric.NW_IN_FOLLOWER] * n_followers[sel]).sum()
                    ) * BYTES_IN_KB
                    out.append(TopicMetric(RawMetricType.TOPIC_BYTES_IN, now_ms, bid, name, t_in))
                    out.append(TopicMetric(RawMetricType.TOPIC_BYTES_OUT, now_ms, bid, name, t_out))
                    out.append(
                        TopicMetric(RawMetricType.TOPIC_REPLICATION_BYTES_IN, now_ms, bid, name, t_rep_in)
                    )
                    out.append(
                        TopicMetric(RawMetricType.TOPIC_REPLICATION_BYTES_OUT, now_ms, bid, name, t_rep_out)
                    )
                    # partition sizes for this topic's leader partitions here
                    for pid in sel:
                        out.append(
                            PartitionMetric(
                                RawMetricType.PARTITION_SIZE,
                                now_ms,
                                bid,
                                name,
                                int(self._meta.partition_index[pid]),
                                float(pl[pid, PartMetric.DISK]) * BYTES_IN_MB,
                            )
                        )
                return out

        return source

    def all_metrics(self, now_ms: int) -> List[CruiseControlMetric]:
        """Every alive broker's metrics for one interval."""
        out: List[CruiseControlMetric] = []
        for i in range(self._state.shape[0]):
            out.extend(self.metric_source(i)(now_ms))
        return out

    # -- executor surface ------------------------------------------------------

    def apply_movement(self, partition: int, source_broker: int, dest_broker: int) -> bool:
        """Replace source_broker with dest_broker in the partition's replica
        set (the reassignment the ZK write would trigger)."""
        with self._lock:
            row = self._assignment[partition]
            slots = np.nonzero(row == source_broker)[0]
            if slots.size == 0 or (row == dest_broker).any():
                return False
            self._assignment[partition, slots[0]] = dest_broker
            return True

    def add_replica(self, partition: int, broker_index: int) -> bool:
        """Grow the partition's replica set (RF increase), widening the
        assignment matrix when every slot is taken."""
        with self._lock:
            row = self._assignment[partition]
            if (row == broker_index).any():
                return False
            free = np.nonzero(row < 0)[0]
            if free.size == 0:
                pad = np.full((self._assignment.shape[0], 1), -1, dtype=np.int32)
                self._assignment = np.concatenate([self._assignment, pad], axis=1)
                self._assignment[partition, -1] = broker_index
            else:
                self._assignment[partition, free[0]] = broker_index
            return True

    def remove_replica(self, partition: int, broker_index: int) -> bool:
        """Drop a non-leader replica (RF decrease), left-packing the row."""
        with self._lock:
            row = self._assignment[partition]
            slots = np.nonzero(row == broker_index)[0]
            if slots.size == 0 or slots[0] == 0:
                return False
            s = slots[0]
            row[s:-1] = row[s + 1 :]
            row[-1] = -1
            return True

    def apply_leadership(self, partition: int, new_leader_broker: int) -> bool:
        """Preferred-leader election to an in-set replica."""
        with self._lock:
            row = self._assignment[partition]
            slots = np.nonzero(row == new_leader_broker)[0]
            if slots.size == 0:
                return False
            s = slots[0]
            row[0], row[s] = row[s], row[0]
            return True

    def kill_broker(self, broker_index: int) -> None:
        with self._lock:
            self._state[broker_index] = BrokerState.DEAD

    def restore_broker(self, broker_index: int) -> None:
        with self._lock:
            self._state[broker_index] = BrokerState.ALIVE

    def revive_broker(self, broker_index: int) -> None:
        """A dead broker re-joins as NEW (not ALIVE): its replicas survived
        on disk but the rebalancer should treat it as a fresh destination —
        the incremental lane's `broker_revival` delta keys off this
        transition (analyzer/incremental.py)."""
        with self._lock:
            if self._state[broker_index] == BrokerState.DEAD:
                self._state[broker_index] = BrokerState.NEW

    # -- topology perturbations (chaos replay, testing/chaos.py) ---------------

    def delete_topic(self, topic: int) -> int:
        """Drop every partition of the topic (the mid-batch topic-delete
        drift case): all partition-axis arrays shrink and the dense indices
        of later partitions SHIFT — exactly the hazard the executor's
        revalidation must catch. Returns the number of partitions removed."""
        with self._lock:
            keep = self._topic_id != int(topic)
            removed = int((~keep).sum())
            if removed == 0:
                return 0
            self._assignment = self._assignment[keep]
            self._part_load = self._part_load[keep]
            self._topic_id = self._topic_id[keep]
            self._meta = ClusterMetadata(
                topic_names=self._meta.topic_names,
                partition_index=np.asarray(self._meta.partition_index)[keep],
                broker_ids=np.asarray(self._meta.broker_ids),
                rack_names=self._meta.rack_names,
                host_names=self._meta.host_names,
                topic_of_partition=self._topic_id.copy(),
            )
            return removed

    def add_partitions(self, topic: int, count: int) -> int:
        """Grow a topic by `count` partitions (the partition-count-change
        drift case): new rows append with replicas round-robined over alive
        brokers and zero load. Returns the new partition count of the topic."""
        with self._lock:
            mask = self._topic_id == int(topic)
            if mask.any():  # new partitions inherit the topic's RF
                rf = int((self._assignment[mask] >= 0).sum(axis=1).max())
            else:
                rf = min(2, int(self._state.shape[0]))
            rf = max(1, rf)
            alive = [int(b) for b in range(self._state.shape[0])
                     if self._state[b] != BrokerState.DEAD]
            if not alive:
                return 0
            pidx = np.asarray(self._meta.partition_index)
            existing = pidx[self._topic_id == int(topic)]
            next_index = int(existing.max()) + 1 if existing.size else 0
            rows = []
            for i in range(count):
                replicas = [alive[(next_index + i + j) % len(alive)]
                            for j in range(min(rf, len(alive)))]
                row = np.full(self._assignment.shape[1], -1, dtype=np.int32)
                row[: len(replicas)] = replicas
                rows.append(row)
            self._assignment = np.concatenate([self._assignment, np.stack(rows)])
            self._part_load = np.concatenate([
                self._part_load,
                np.zeros((count, self._part_load.shape[1]), dtype=np.float32),
            ])
            self._topic_id = np.concatenate([
                self._topic_id, np.full(count, int(topic), dtype=np.int32)
            ])
            self._meta = ClusterMetadata(
                topic_names=self._meta.topic_names,
                partition_index=np.concatenate([
                    pidx, np.arange(next_index, next_index + count, dtype=np.int32)
                ]),
                broker_ids=np.asarray(self._meta.broker_ids),
                rack_names=self._meta.rack_names,
                host_names=self._meta.host_names,
                topic_of_partition=self._topic_id.copy(),
            )
            return int((self._topic_id == int(topic)).sum())

    def spike_load(self, topic: int, factor: float) -> None:
        """Multiply the topic's partition load (hot-load spike): no topology
        change, so the metadata generation must NOT bump — load drift is the
        optimizer's business, not admission's."""
        with self._lock:
            self._part_load[self._topic_id == int(topic)] *= np.float32(factor)

    def replication_factor_of(self, partition: int) -> int:
        with self._lock:
            return int((self._assignment[partition] >= 0).sum())

    def has_partition(self, partition: int, broker_index: int) -> bool:
        with self._lock:
            return bool((self._assignment[partition] == broker_index).any())

    def leader_of(self, partition: int) -> int:
        with self._lock:
            return int(self._assignment[partition, 0])
