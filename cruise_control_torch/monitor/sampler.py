"""Metric sampler SPI + default transport-backed implementation.

Analogs of MetricSampler (cc/monitor/sampling/MetricSampler.java:24, the
pluggable sample source) and CruiseControlMetricsReporterSampler
(cc/monitor/sampling/CruiseControlMetricsReporterSampler.java:37, which polls
the metrics topic and runs the processor)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from cruise_control_torch.monitor.metadata import ClusterTopology
from cruise_control_torch.monitor.processor import MetricsProcessor
from cruise_control_torch.monitor.samples import BrokerMetricSample, PartitionMetricSample
from cruise_control_torch.reporter.transport import MetricsTransport


@dataclasses.dataclass
class Samples:
    """MetricSampler.Samples analog."""

    partition_samples: List[PartitionMetricSample]
    broker_samples: List[BrokerMetricSample]


class MetricSampler:
    """SPI: fetch one round of samples for (a shard of) the cluster.

    `partitions` (optional i32[...] dense partition indices) is the shard
    assigned by the fetcher manager's partition assignor; None means the
    whole cluster. Samplers that pull from a self-distributing source (e.g.
    a consumer group over the metrics topic) may ignore it."""

    def get_samples(self, topology: ClusterTopology, start_ms: int, end_ms: int,
                    partitions=None) -> Samples:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NoopSampler(MetricSampler):
    def get_samples(self, topology, start_ms, end_ms, partitions=None) -> Samples:
        return Samples([], [])


class TransportMetricSampler(MetricSampler):
    """Polls raw metrics off a MetricsTransport and derives samples — the
    default sampler, mirroring CruiseControlMetricsReporterSampler's
    consumer-poll + processor flow."""

    def __init__(self, transport: MetricsTransport, processor: Optional[MetricsProcessor] = None,
                 max_records_per_round: int = 5_000_000):
        self._transport = transport
        self._processor = processor or MetricsProcessor()
        self._max_records = max_records_per_round
        #: records polled off the at-most-once transport whose timestamp is
        #: ahead of the round's range; carried to the next round instead of
        #: being lost (publish can race the round boundary)
        self._carry: list = []

    def get_samples(self, topology: ClusterTopology, start_ms: int, end_ms: int,
                    partitions=None) -> Samples:
        # `partitions` is ignored: transport consumers self-distribute records
        # (the consumer-group semantics of the reference's default sampler),
        # so post-poll filtering would drop other shards' records for good.
        raw = self._carry + self._transport.poll(self._max_records)
        in_range = [m for m in raw if start_ms <= m.time_ms < end_ms]
        self._carry = [m for m in raw if m.time_ms >= end_ms]
        if not in_range:
            return Samples([], [])
        result = self._processor.process(in_range, topology)
        return Samples(result.partition_samples, result.broker_samples)
