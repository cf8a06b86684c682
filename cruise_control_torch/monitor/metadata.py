"""Cluster topology source + broker capacity resolution.

Analogs of MetadataClient (cc/common/MetadataClient.java — TTL-cached Kafka
metadata with a generation counter) and the BrokerCapacityConfigResolver SPI
(cc/config/BrokerCapacityConfigResolver.java:16 /
BrokerCapacityConfigFileResolver.java:69 reading config/capacity.json). The
topology is already in flat-array form so LoadMonitor can assemble a
FlatClusterModel without an object-graph intermediate.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from cruise_control_torch.common.resources import NUM_RESOURCES, BrokerState, Resource


@dataclasses.dataclass(frozen=True)
class ClusterTopology:
    """Flat snapshot of cluster structure (no load)."""

    topic_names: Tuple[str, ...]
    topic_id: np.ndarray  # i32[P]
    partition_index: np.ndarray  # i32[P] partition number within topic
    assignment: np.ndarray  # i32[P, R]; slot 0 = leader, -1 pad
    broker_ids: np.ndarray  # i32[B] external ids (dense index -> external)
    broker_rack: np.ndarray  # i32[B]
    broker_host: np.ndarray  # i32[B]
    broker_state: np.ndarray  # i32[B]
    generation: int = 0

    @property
    def num_partitions(self) -> int:
        return self.topic_id.shape[0]

    @property
    def num_brokers(self) -> int:
        return self.broker_ids.shape[0]

    def broker_index_of(self) -> Dict[int, int]:
        return {int(b): i for i, b in enumerate(self.broker_ids)}

    def leader_topic_counts(self) -> np.ndarray:
        """i32[B, T]: leader partitions per (broker, topic) — the processor's
        leaderDistributionStats (CruiseControlMetricsProcessor.java:208)."""
        b, t = self.num_brokers, len(self.topic_names)
        leaders = self.assignment[:, 0]
        ok = leaders >= 0
        flat = leaders[ok] * t + self.topic_id[ok]
        counts = np.bincount(flat, minlength=b * t).astype(np.int32)
        return counts.reshape(b, t)


class MetadataClient:
    """TTL-cached topology provider. `fetch` is the pluggable backend (a Kafka
    admin client in production; a simulator in tests)."""

    def __init__(self, fetch: Callable[[], ClusterTopology], ttl_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self._fetch = fetch
        self._ttl = ttl_s
        self._clock = clock
        self._lock = threading.Lock()
        self._cached: Optional[ClusterTopology] = None
        self._fetched_at = -float("inf")
        self._generation = 0

    def refresh_metadata(self, force: bool = False) -> ClusterTopology:
        with self._lock:
            now = self._clock()
            if force or self._cached is None or now - self._fetched_at > self._ttl:
                topo = self._fetch()
                if self._cached is None or not _same_topology(self._cached, topo):
                    self._generation += 1
                self._cached = dataclasses.replace(topo, generation=self._generation)
                self._fetched_at = now
            return self._cached

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation


def _same_topology(a: ClusterTopology, b: ClusterTopology) -> bool:
    return (
        a.topic_names == b.topic_names
        and a.assignment.shape == b.assignment.shape
        and np.array_equal(a.assignment, b.assignment)
        and np.array_equal(a.broker_state, b.broker_state)
    )


# -- capacity resolution -------------------------------------------------------

DEFAULT_CAPACITY_BROKER_ID = -1


class BrokerCapacityConfigResolver:
    """SPI: external broker id -> f32[4] capacity vector
    (units: CPU in %, NW in KB/s, DISK in MB — same as capacity.json)."""

    def capacity_for_broker(self, broker_id: int) -> np.ndarray:
        raise NotImplementedError


class BrokerCapacityConfigFileResolver(BrokerCapacityConfigResolver):
    """Reads the reference's capacity.json format
    (cc/config/BrokerCapacityConfigFileResolver.java:69, config/capacity.json):
    a list of {brokerId, capacity: {DISK, CPU, NW_IN, NW_OUT}} entries with
    brokerId -1 as the default.

    Both disk variants are supported: the flat form (`"DISK": "100000"`) and
    the JBOD form (`"DISK": {"/logdir1": "250000", "/logdir2": "250000"}` —
    capacity.JBOD.json), where the broker's DISK capacity is the sum of its
    log dirs; the per-logdir map is kept on `logdirs_for_broker` for
    disk-level reporting."""

    def __init__(self, path: str):
        with open(path) as f:
            doc = json.load(f)
        self._by_broker: Dict[int, np.ndarray] = {}
        self._logdirs: Dict[int, Dict[str, float]] = {}
        for entry in doc["brokerCapacities"]:
            broker_id = int(entry["brokerId"])
            cap = np.zeros(NUM_RESOURCES, dtype=np.float32)
            for name, value in entry["capacity"].items():
                if isinstance(value, dict):  # JBOD per-logdir disks
                    if Resource[name] != Resource.DISK:
                        raise ValueError(
                            f"per-logdir capacities only apply to DISK, got {name}"
                        )
                    dirs = {d: float(v) for d, v in value.items()}
                    self._logdirs[broker_id] = dirs
                    cap[Resource.DISK] = sum(dirs.values())
                else:
                    cap[Resource[name]] = float(value)
            self._by_broker[broker_id] = cap
        if DEFAULT_CAPACITY_BROKER_ID not in self._by_broker:
            raise ValueError("capacity config must define the default (brokerId -1)")

    def capacity_for_broker(self, broker_id: int) -> np.ndarray:
        cap = self._by_broker.get(int(broker_id))
        return cap.copy() if cap is not None else self._by_broker[DEFAULT_CAPACITY_BROKER_ID].copy()

    def logdirs_for_broker(self, broker_id: int) -> Dict[str, float]:
        """Per-logdir DISK capacities (JBOD variant); {} for flat entries.
        Brokers without an explicit entry inherit the default's dirs."""
        bid = int(broker_id)
        if bid in self._by_broker:
            return dict(self._logdirs.get(bid, {}))
        return dict(self._logdirs.get(DEFAULT_CAPACITY_BROKER_ID, {}))


class StaticCapacityResolver(BrokerCapacityConfigResolver):
    """Uniform capacity for simulations/tests."""

    def __init__(self, cpu=100.0, nw_in=1e5, nw_out=1e5, disk=1e6):
        self._cap = np.zeros(NUM_RESOURCES, dtype=np.float32)
        self._cap[Resource.CPU] = cpu
        self._cap[Resource.NW_IN] = nw_in
        self._cap[Resource.NW_OUT] = nw_out
        self._cap[Resource.DISK] = disk

    def capacity_for_broker(self, broker_id: int) -> np.ndarray:
        return self._cap.copy()
