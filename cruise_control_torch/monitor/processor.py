"""Raw metric -> sample derivation.

Analog of CruiseControlMetricsProcessor (cc/monitor/sampling/
CruiseControlMetricsProcessor.java:38): groups one reporting interval's raw
metrics by broker, derives per-partition samples from topic-level IO (split
evenly across the topic's leader partitions on that broker,
buildPartitionMetricSample :220-267) and attributes per-partition CPU from the
broker's measured CPU and byte rates (ModelUtils.estimateLeaderCpuUtil), with
the reference's skip rules when inputs are missing. Vectorized over the whole
batch with numpy grouping instead of per-partition object walks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from cruise_control_torch.models.model_utils import estimate_leader_cpu_util
from cruise_control_torch.monitor.metadata import ClusterTopology
from cruise_control_torch.monitor.metricdef import (
    NUM_BROKER_METRICS,
    NUM_COMMON_METRICS,
    TYPE_TO_DEF,
    KafkaMetricDef,
)
from cruise_control_torch.monitor.samples import (
    BrokerMetricSample,
    PartitionMetricSample,
    SampleBatch,
)
from cruise_control_torch.reporter.metrics import CruiseControlMetric, MetricScope, RawMetricType

BYTES_IN_KB = 1024.0
BYTES_IN_MB = 1024.0 * 1024.0

_BYTE_RATE_TYPES = {
    RawMetricType.ALL_TOPIC_BYTES_IN,
    RawMetricType.ALL_TOPIC_BYTES_OUT,
    RawMetricType.ALL_TOPIC_REPLICATION_BYTES_IN,
    RawMetricType.ALL_TOPIC_REPLICATION_BYTES_OUT,
    RawMetricType.TOPIC_BYTES_IN,
    RawMetricType.TOPIC_BYTES_OUT,
    RawMetricType.TOPIC_REPLICATION_BYTES_IN,
    RawMetricType.TOPIC_REPLICATION_BYTES_OUT,
}


def _convert_unit(metric_type: RawMetricType, value: float) -> float:
    """CruiseControlMetricsProcessor.convertUnit: byte rates -> KB/s,
    partition size -> MB."""
    if metric_type in _BYTE_RATE_TYPES:
        return value / BYTES_IN_KB
    if metric_type == RawMetricType.PARTITION_SIZE:
        return value / BYTES_IN_MB
    return value


@dataclasses.dataclass
class ProcessorResult:
    partition_samples: "SampleBatch"  # array-native; iterable as records
    broker_samples: List[BrokerMetricSample]
    skipped_partitions: int
    skipped_brokers: int


class MetricsProcessor:
    """One reporting interval in, derived samples out."""

    def __init__(self):
        # (topology generation, id) -> sorted partition key table so repeated
        # rounds against an unchanged topology skip the O(P) rebuild
        self._key_cache: Optional[tuple] = None

    def process(
        self,
        metrics: Iterable[CruiseControlMetric],
        topology: ClusterTopology,
    ) -> ProcessorResult:
        broker_index = topology.broker_index_of()
        topic_index = {name: i for i, name in enumerate(topology.topic_names)}
        b, t = topology.num_brokers, len(topology.topic_names)

        # -- bucket the batch --------------------------------------------------
        broker_vals: Dict[int, Dict[RawMetricType, float]] = {}
        broker_time: Dict[int, int] = {}
        topic_vals = np.zeros((b, t, 7), dtype=np.float64)  # 7 topic metric types
        topic_seen = np.zeros((b, t), dtype=bool)
        size_seen = np.zeros((b, t), dtype=bool)

        topic_slot = {
            RawMetricType.TOPIC_BYTES_IN: 0,
            RawMetricType.TOPIC_BYTES_OUT: 1,
            RawMetricType.TOPIC_REPLICATION_BYTES_IN: 2,
            RawMetricType.TOPIC_REPLICATION_BYTES_OUT: 3,
            RawMetricType.TOPIC_PRODUCE_REQUEST_RATE: 4,
            RawMetricType.TOPIC_FETCH_REQUEST_RATE: 5,
            RawMetricType.TOPIC_MESSAGES_IN_PER_SEC: 6,
        }
        size_b: List[int] = []
        size_t: List[int] = []
        size_p: List[int] = []
        size_v: List[float] = []

        for m in metrics:
            bi = broker_index.get(m.broker_id)
            if bi is None:
                continue
            value = _convert_unit(m.metric_type, m.value)
            scope = m.metric_type.scope
            if scope == MetricScope.BROKER:
                broker_vals.setdefault(bi, {})[m.metric_type] = value
                broker_time[bi] = max(broker_time.get(bi, 0), m.time_ms)
            elif scope == MetricScope.TOPIC:
                ti = topic_index.get(m.topic)
                if ti is not None:
                    topic_vals[bi, ti, topic_slot[m.metric_type]] = value
                    topic_seen[bi, ti] = True
            else:  # PARTITION (only PARTITION_SIZE exists)
                ti = topic_index.get(m.topic)
                if ti is not None:
                    size_b.append(bi)
                    size_t.append(ti)
                    size_p.append(m.partition)
                    size_v.append(value)
                    size_seen[bi, ti] = True

        # topics with sizes reported but no IO metrics had zero traffic
        # (BrokerLoad._dotHandledTopicsWithPartitionSizeReported comment)
        topic_ok = topic_seen | size_seen

        # -- broker samples ----------------------------------------------------
        broker_samples: List[BrokerMetricSample] = []
        skipped_brokers = 0
        broker_ok = np.zeros(b, dtype=bool)
        broker_cpu = np.zeros(b)
        broker_l_in = np.zeros(b)
        broker_total_out = np.zeros(b)
        broker_f_in = np.zeros(b)
        for bi, vals in broker_vals.items():
            if RawMetricType.BROKER_CPU_UTIL not in vals:
                skipped_brokers += 1
                continue
            vec = np.zeros(NUM_BROKER_METRICS, dtype=np.float32)
            for raw_type, value in vals.items():
                d = TYPE_TO_DEF.get(raw_type)
                if d is not None:
                    vec[d] = value
            broker_samples.append(BrokerMetricSample(bi, broker_time.get(bi, 0), vec))
            broker_ok[bi] = True
            broker_cpu[bi] = vals[RawMetricType.BROKER_CPU_UTIL]
            broker_l_in[bi] = vals.get(RawMetricType.ALL_TOPIC_BYTES_IN, 0.0)
            broker_total_out[bi] = vals.get(RawMetricType.ALL_TOPIC_BYTES_OUT, 0.0) + vals.get(
                RawMetricType.ALL_TOPIC_REPLICATION_BYTES_OUT, 0.0
            )
            broker_f_in[bi] = vals.get(RawMetricType.ALL_TOPIC_REPLICATION_BYTES_IN, 0.0)

        # -- partition samples (vectorized over P) -----------------------------
        leaders = np.asarray(topology.assignment[:, 0])
        topics = np.asarray(topology.topic_id)
        p = topology.num_partitions
        valid = (leaders >= 0) & broker_ok[np.clip(leaders, 0, b - 1)]
        lt_ok = topic_ok[np.clip(leaders, 0, b - 1), topics]
        valid &= lt_ok

        sizes = np.full(p, np.nan)
        if size_b:
            # map (broker, topic, partition-index) keys onto dense partition
            # ids via a sorted int64 key table, cached per topology generation
            pmax = int(np.asarray(topology.partition_index).max()) + 1
            cache_tag = (topology.generation, p, b, t, pmax)
            if self._key_cache is None or self._key_cache[0] != cache_tag:
                table = (
                    (leaders.astype(np.int64) * t + topics) * pmax
                    + np.asarray(topology.partition_index, dtype=np.int64)
                )
                order = np.argsort(table, kind="stable")
                self._key_cache = (cache_tag, table[order], order)
            _, sorted_keys, order = self._key_cache
            query = (
                (np.asarray(size_b, dtype=np.int64) * t + np.asarray(size_t, dtype=np.int64)) * pmax
                + np.asarray(size_p, dtype=np.int64)
            )
            pos = np.searchsorted(sorted_keys, query)
            pos_ok = (pos < p) & (sorted_keys[np.clip(pos, 0, p - 1)] == query)
            pid_hit = order[pos[pos_ok]]
            sizes[pid_hit] = np.asarray(size_v)[pos_ok]
        valid &= ~np.isnan(sizes)

        n_leaders = topology.leader_topic_counts()  # [B, T]
        safe_leaders = np.clip(leaders, 0, b - 1)
        denom = np.maximum(n_leaders[safe_leaders, topics], 1)
        rates = topic_vals[safe_leaders, topics] / denom[:, None]  # [P, 7]

        part_in = rates[:, 0]
        part_out = rates[:, 1]
        part_rep_out = rates[:, 3]
        cpu = estimate_leader_cpu_util(
            broker_cpu[safe_leaders],
            broker_l_in[safe_leaders],
            broker_total_out[safe_leaders],
            broker_f_in[safe_leaders],
            part_in,
            part_out + part_rep_out,
        )
        valid &= ~np.isnan(cpu)

        # assemble the whole [N_valid, M] matrix with column writes — no
        # per-partition Python objects on the hot path
        time_ms = max(broker_time.values(), default=0)
        pids = np.nonzero(valid)[0]
        mat = np.zeros((pids.shape[0], NUM_COMMON_METRICS), dtype=np.float32)
        mat[:, KafkaMetricDef.CPU_USAGE] = cpu[pids]
        mat[:, KafkaMetricDef.DISK_USAGE] = sizes[pids]
        mat[:, KafkaMetricDef.LEADER_BYTES_IN] = rates[pids, 0]
        mat[:, KafkaMetricDef.LEADER_BYTES_OUT] = rates[pids, 1]
        mat[:, KafkaMetricDef.REPLICATION_BYTES_IN_RATE] = rates[pids, 2]
        mat[:, KafkaMetricDef.REPLICATION_BYTES_OUT_RATE] = rates[pids, 3]
        mat[:, KafkaMetricDef.PRODUCE_RATE] = rates[pids, 4]
        mat[:, KafkaMetricDef.FETCH_RATE] = rates[pids, 5]
        mat[:, KafkaMetricDef.MESSAGE_IN_RATE] = rates[pids, 6]
        partition_samples = SampleBatch(
            ids=pids.astype(np.int64),
            times=np.full(pids.shape[0], time_ms, dtype=np.int64),
            metrics=mat,
            kind="partition",
        )

        return ProcessorResult(
            partition_samples=partition_samples,
            broker_samples=broker_samples,
            skipped_partitions=int(p - valid.sum()),
            skipped_brokers=skipped_brokers,
        )
