"""Raw metric taxonomy + versioned binary serde.

Mirrors the reference's metric vocabulary exactly — RawMetricType
(mr/metric/RawMetricType.java:27-80: 63 typed metrics over
BROKER/TOPIC/PARTITION scopes with a version watermark per type) and the
record classes CruiseControlMetric/BrokerMetric/TopicMetric/PartitionMetric +
MetricSerde (mr/metric/MetricSerde.java) — so dashboards/tooling written
against the reference taxonomy carry over.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Optional


class MetricScope(enum.IntEnum):
    BROKER = 0
    TOPIC = 1
    PARTITION = 2


_BROKER = MetricScope.BROKER
_TOPIC = MetricScope.TOPIC
_PARTITION = MetricScope.PARTITION


class RawMetricType(enum.IntEnum):
    """Same names and wire ids as mr/metric/RawMetricType.java:27-80."""

    ALL_TOPIC_BYTES_IN = 0
    ALL_TOPIC_BYTES_OUT = 1
    TOPIC_BYTES_IN = 2
    TOPIC_BYTES_OUT = 3
    PARTITION_SIZE = 4
    BROKER_CPU_UTIL = 5
    ALL_TOPIC_REPLICATION_BYTES_IN = 6
    ALL_TOPIC_REPLICATION_BYTES_OUT = 7
    ALL_TOPIC_PRODUCE_REQUEST_RATE = 8
    ALL_TOPIC_FETCH_REQUEST_RATE = 9
    ALL_TOPIC_MESSAGES_IN_PER_SEC = 10
    TOPIC_REPLICATION_BYTES_IN = 11
    TOPIC_REPLICATION_BYTES_OUT = 12
    TOPIC_PRODUCE_REQUEST_RATE = 13
    TOPIC_FETCH_REQUEST_RATE = 14
    TOPIC_MESSAGES_IN_PER_SEC = 15
    BROKER_PRODUCE_REQUEST_RATE = 16
    BROKER_CONSUMER_FETCH_REQUEST_RATE = 17
    BROKER_FOLLOWER_FETCH_REQUEST_RATE = 18
    BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT = 19
    BROKER_REQUEST_QUEUE_SIZE = 20
    BROKER_RESPONSE_QUEUE_SIZE = 21
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX = 22
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN = 23
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MAX = 24
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN = 25
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MAX = 26
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN = 27
    BROKER_PRODUCE_TOTAL_TIME_MS_MAX = 28
    BROKER_PRODUCE_TOTAL_TIME_MS_MEAN = 29
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MAX = 30
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MEAN = 31
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MAX = 32
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MEAN = 33
    BROKER_PRODUCE_LOCAL_TIME_MS_MAX = 34
    BROKER_PRODUCE_LOCAL_TIME_MS_MEAN = 35
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MAX = 36
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN = 37
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MAX = 38
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN = 39
    BROKER_LOG_FLUSH_RATE = 40
    BROKER_LOG_FLUSH_TIME_MS_MAX = 41
    BROKER_LOG_FLUSH_TIME_MS_MEAN = 42
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_50TH = 43
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_999TH = 44
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_50TH = 45
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_999TH = 46
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_50TH = 47
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_999TH = 48
    BROKER_PRODUCE_TOTAL_TIME_MS_50TH = 49
    BROKER_PRODUCE_TOTAL_TIME_MS_999TH = 50
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_50TH = 51
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_999TH = 52
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_50TH = 53
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_999TH = 54
    BROKER_PRODUCE_LOCAL_TIME_MS_50TH = 55
    BROKER_PRODUCE_LOCAL_TIME_MS_999TH = 56
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_50TH = 57
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_999TH = 58
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_50TH = 59
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_999TH = 60
    BROKER_LOG_FLUSH_TIME_MS_50TH = 61
    BROKER_LOG_FLUSH_TIME_MS_999TH = 62

    @property
    def scope(self) -> MetricScope:
        return METRIC_SCOPE[self]

    @property
    def supported_version_since(self) -> int:
        """First serde version carrying this type (-1 = always supported),
        matching RawMetricType's per-type version watermark."""
        return METRIC_VERSION_SINCE[self]


_TOPIC_TYPES = {
    RawMetricType.TOPIC_BYTES_IN,
    RawMetricType.TOPIC_BYTES_OUT,
    RawMetricType.TOPIC_REPLICATION_BYTES_IN,
    RawMetricType.TOPIC_REPLICATION_BYTES_OUT,
    RawMetricType.TOPIC_PRODUCE_REQUEST_RATE,
    RawMetricType.TOPIC_FETCH_REQUEST_RATE,
    RawMetricType.TOPIC_MESSAGES_IN_PER_SEC,
}

METRIC_SCOPE = {
    t: (
        MetricScope.PARTITION
        if t == RawMetricType.PARTITION_SIZE
        else MetricScope.TOPIC
        if t in _TOPIC_TYPES
        else MetricScope.BROKER
    )
    for t in RawMetricType
}

#: BROKER types gained version watermarks in the reference (v4 for rate/time
#: means, v5 for percentiles); TOPIC/PARTITION types are versionless (-1).
METRIC_VERSION_SINCE = {
    t: (-1 if t.scope != MetricScope.BROKER else (5 if t >= RawMetricType.BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_50TH else 4))
    for t in RawMetricType
}

BROKER_METRIC_TYPES = [t for t in RawMetricType if t.scope == MetricScope.BROKER]
TOPIC_METRIC_TYPES = [t for t in RawMetricType if t.scope == MetricScope.TOPIC]
PARTITION_METRIC_TYPES = [t for t in RawMetricType if t.scope == MetricScope.PARTITION]


@dataclasses.dataclass(frozen=True)
class CruiseControlMetric:
    """One raw metric observation (mr/metric/CruiseControlMetric.java)."""

    metric_type: RawMetricType
    time_ms: int
    broker_id: int
    value: float
    topic: Optional[str] = None
    partition: Optional[int] = None

    def __post_init__(self):
        scope = self.metric_type.scope
        if scope == MetricScope.TOPIC and self.topic is None:
            raise ValueError(f"{self.metric_type.name} requires a topic")
        if scope == MetricScope.PARTITION and (self.topic is None or self.partition is None):
            raise ValueError(f"{self.metric_type.name} requires topic and partition")


def BrokerMetric(metric_type, time_ms, broker_id, value) -> CruiseControlMetric:
    return CruiseControlMetric(metric_type, time_ms, broker_id, value)


def TopicMetric(metric_type, time_ms, broker_id, topic, value) -> CruiseControlMetric:
    return CruiseControlMetric(metric_type, time_ms, broker_id, value, topic=topic)


def PartitionMetric(metric_type, time_ms, broker_id, topic, partition, value) -> CruiseControlMetric:
    return CruiseControlMetric(metric_type, time_ms, broker_id, value, topic=topic, partition=partition)


# -- wire format ---------------------------------------------------------------

SERDE_VERSION = 1

# header: version u8, type u8, time i64, broker i32, value f64, topic_len u16
_HEADER = struct.Struct(">BBqid H")


def serialize_metric(m: CruiseControlMetric) -> bytes:
    """Versioned binary serde, the analog of MetricSerde.toBytes
    (mr/metric/MetricSerde.java)."""
    topic_bytes = m.topic.encode("utf-8") if m.topic is not None else b""
    out = _HEADER.pack(
        SERDE_VERSION, int(m.metric_type), m.time_ms, m.broker_id, m.value, len(topic_bytes)
    )
    out += topic_bytes
    if m.metric_type.scope == MetricScope.PARTITION:
        out += struct.pack(">i", m.partition)
    return out


def deserialize_metric(data: bytes) -> CruiseControlMetric:
    version, type_id, time_ms, broker_id, value, topic_len = _HEADER.unpack_from(data, 0)
    if version > SERDE_VERSION:
        raise ValueError(f"unsupported metric serde version {version}")
    mt = RawMetricType(type_id)
    off = _HEADER.size
    topic = data[off : off + topic_len].decode("utf-8") if topic_len else None
    off += topic_len
    partition = None
    if mt.scope == MetricScope.PARTITION:
        (partition,) = struct.unpack_from(">i", data, off)
    return CruiseControlMetric(mt, time_ms, broker_id, value, topic=topic, partition=partition)
