"""Broker-side metrics agent analog.

The reference runs `CruiseControlMetricsReporter` inside every Kafka broker
(mr/CruiseControlMetricsReporter.java:41) pumping ~50 typed raw metrics to the
`__CruiseControlMetrics` topic. Here the agent is a host-side sampler thread
publishing the same taxonomy through a pluggable transport (in-memory queue,
JSONL file, or any user SPI impl) that the monitor's sampler consumes.
"""

from cruise_control_torch.reporter.metrics import (
    BrokerMetric,
    CruiseControlMetric,
    MetricScope,
    PartitionMetric,
    RawMetricType,
    TopicMetric,
    deserialize_metric,
    serialize_metric,
)
from cruise_control_torch.reporter.transport import (
    InMemoryTransport,
    JsonlFileTransport,
    MetricsTransport,
)
from cruise_control_torch.reporter.reporter import MetricsReporter, MetricsReporterConfig

__all__ = [
    "BrokerMetric",
    "CruiseControlMetric",
    "InMemoryTransport",
    "JsonlFileTransport",
    "MetricScope",
    "MetricsReporter",
    "MetricsReporterConfig",
    "MetricsTransport",
    "PartitionMetric",
    "RawMetricType",
    "TopicMetric",
    "deserialize_metric",
    "serialize_metric",
]
