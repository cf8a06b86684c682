"""N-way parallel metric fetching with topic-sticky partition assignment.

The redesign of MetricFetcherManager (cc/monitor/sampling/MetricFetcherManager
.java:35, fetchPartitionMetricSamples :175) and
DefaultMetricSamplerPartitionAssignor (cc/monitor/sampling/
DefaultMetricSamplerPartitionAssignor.java): the cluster's partitions are
split across N fetcher workers — every partition of a topic stays on one
fetcher so per-topic derivations see complete data — and a sampling round
runs the workers concurrently under one deadline. A slow or failing fetcher
loses only its shard (counted in the per-fetcher failure meters), never the
round.

`MetricFetcherManager.get_samples` has the `MetricSampler` signature on
purpose: the LoadMonitor takes the manager wherever a single sampler fits,
so single-threaded setups keep the plain sampler and large clusters drop in
the manager without the monitor changing.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from cruise_control_torch.monitor.metadata import ClusterTopology
from cruise_control_torch.monitor.sampler import MetricSampler, Samples


class MetricSamplerPartitionAssignor:
    """SPI: split partition indices across fetchers
    (cc/monitor/sampling/MetricSamplerPartitionAssignor.java)."""

    def assign(self, topology: ClusterTopology, num_fetchers: int) -> List[np.ndarray]:
        raise NotImplementedError


class DefaultMetricSamplerPartitionAssignor(MetricSamplerPartitionAssignor):
    """Topic-sticky greedy packing: topics (largest first) go to the fetcher
    with the fewest assigned partitions, so all partitions of one topic land
    on one fetcher (the reference's invariant) and shard sizes stay balanced.
    """

    def assign(self, topology: ClusterTopology, num_fetchers: int) -> List[np.ndarray]:
        topic_id = np.asarray(topology.topic_id)
        num_topics = int(topic_id.max()) + 1 if topic_id.size else 0
        counts = np.bincount(topic_id, minlength=num_topics)
        order = np.argsort(-counts, kind="stable")  # largest topics first
        loads = np.zeros(num_fetchers, dtype=np.int64)
        topic_owner = np.zeros(num_topics, dtype=np.int64)
        for t in order:
            f = int(np.argmin(loads))
            topic_owner[t] = f
            loads[f] += counts[t]
        owner_of_partition = topic_owner[topic_id]
        return [
            np.nonzero(owner_of_partition == f)[0].astype(np.int32)
            for f in range(num_fetchers)
        ]


class MetricFetcherManager:
    """Runs one sampler per fetcher thread over its assigned shard.

    Sensors mirror the reference's fetcher timers/meters
    (MetricFetcherManager's `partition-samples-fetcher-timer`,
    `*-fetcher-failure-rate`; docs/wiki "Sensors.md").
    """

    def __init__(
        self,
        samplers: Sequence[MetricSampler],
        assignor: Optional[MetricSamplerPartitionAssignor] = None,
        round_timeout_s: float = 30.0,
        clock=time.monotonic,
    ):
        if not samplers:
            raise ValueError("need at least one sampler")
        self._samplers = list(samplers)
        self._assignor = assignor or DefaultMetricSamplerPartitionAssignor()
        self._timeout = round_timeout_s
        self._clock = clock
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=len(self._samplers), thread_name_prefix="metric-fetcher"
        )
        self._lock = threading.Lock()
        n = len(self._samplers)
        self.sensors: Dict[str, object] = {
            "fetch_rounds": 0,
            "fetcher_time_s": [0.0] * n,
            "fetcher_rounds": [0] * n,
            "fetcher_failures": [0] * n,
            "fetcher_timeouts": [0] * n,
            "fetcher_skipped_busy": [0] * n,
        }
        #: round N's future per fetcher; a fetcher whose previous call is
        #: still running is skipped next round — two concurrent get_samples
        #: calls on one sampler would race its internal state
        self._inflight: List[Optional[concurrent.futures.Future]] = [None] * n

    @property
    def num_fetchers(self) -> int:
        return len(self._samplers)

    def get_samples(self, topology: ClusterTopology, start_ms: int, end_ms: int,
                    partitions=None) -> Samples:
        """One sampling round (fetchPartitionMetricSamples :175): fan out the
        shards, merge whatever returns before the deadline.

        A fetcher whose previous round is still running (it timed out — the
        thread cannot be killed) is skipped so one sampler never runs two
        concurrent calls; its shard is lost for this round and counted in
        `fetcher_skipped_busy`. `partitions` narrows the round to a subset
        (the manager itself satisfies the MetricSampler SPI)."""
        assignment = self._assignor.assign(topology, len(self._samplers))
        if partitions is not None:
            wanted = np.asarray(partitions)
            assignment = [
                shard[np.isin(shard, wanted)] for shard in assignment
            ]
        deadline = self._clock() + self._timeout
        futures = {}
        for i, (sampler, shard) in enumerate(zip(self._samplers, assignment)):
            prev = self._inflight[i]
            if prev is not None and not prev.done():
                with self._lock:
                    self.sensors["fetcher_skipped_busy"][i] += 1
                continue
            futures[i] = self._pool.submit(
                self._fetch_one, i, sampler, topology, shard, start_ms, end_ms
            )
            self._inflight[i] = futures[i]
        part, brok = [], []
        for i, fut in futures.items():
            remaining = max(0.0, deadline - self._clock())
            try:
                samples = fut.result(timeout=remaining)
            except concurrent.futures.TimeoutError:
                with self._lock:
                    self.sensors["fetcher_timeouts"][i] += 1
                continue
            except Exception:
                with self._lock:
                    self.sensors["fetcher_failures"][i] += 1
                continue
            part.extend(samples.partition_samples)
            brok.extend(samples.broker_samples)
        with self._lock:
            self.sensors["fetch_rounds"] += 1
        return Samples(part, brok)

    def _fetch_one(self, i, sampler, topology, shard, start_ms, end_ms) -> Samples:
        t0 = self._clock()
        try:
            return sampler.get_samples(topology, start_ms, end_ms, partitions=shard)
        finally:
            with self._lock:
                self.sensors["fetcher_time_s"][i] += self._clock() - t0
                self.sensors["fetcher_rounds"][i] += 1

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        for s in self._samplers:
            s.close()
