"""Metric definitions: raw types -> aggregation strategy -> Resource.

The analog of KafkaMetricDef (cc/monitor/metricdefinition/KafkaMetricDef.java:41-51)
and the core MetricDef/MetricInfo registry (core/metricdef/): each defined
metric has a dense integer id (its array column), a value-computing strategy
(AVG / MAX / LATEST, core/metricdef/ValueComputingStrategy.java:10), and an
optional Resource it contributes to.

COMMON defs exist for both partitions and brokers (the partition sample
columns); BROKER_ONLY defs extend the broker sample with queue/latency/flush
telemetry used by the metric-anomaly detector.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional

from cruise_control_torch.common.resources import Resource
from cruise_control_torch.reporter.metrics import RawMetricType


class AggregationFunction(enum.IntEnum):
    AVG = 0
    MAX = 1
    LATEST = 2


class DefScope(enum.IntEnum):
    COMMON = 0
    BROKER_ONLY = 1


class KafkaMetricDef(enum.IntEnum):
    """Dense metric ids; COMMON block first so partition samples are a prefix."""

    CPU_USAGE = 0
    DISK_USAGE = 1
    LEADER_BYTES_IN = 2
    LEADER_BYTES_OUT = 3
    PRODUCE_RATE = 4
    FETCH_RATE = 5
    MESSAGE_IN_RATE = 6
    REPLICATION_BYTES_IN_RATE = 7
    REPLICATION_BYTES_OUT_RATE = 8
    # broker-only telemetry
    BROKER_PRODUCE_REQUEST_RATE = 9
    BROKER_CONSUMER_FETCH_REQUEST_RATE = 10
    BROKER_FOLLOWER_FETCH_REQUEST_RATE = 11
    BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT = 12
    BROKER_REQUEST_QUEUE_SIZE = 13
    BROKER_RESPONSE_QUEUE_SIZE = 14
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX = 15
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN = 16
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MAX = 17
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN = 18
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MAX = 19
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN = 20
    BROKER_PRODUCE_TOTAL_TIME_MS_MAX = 21
    BROKER_PRODUCE_TOTAL_TIME_MS_MEAN = 22
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MAX = 23
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MEAN = 24
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MAX = 25
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MEAN = 26
    BROKER_PRODUCE_LOCAL_TIME_MS_MAX = 27
    BROKER_PRODUCE_LOCAL_TIME_MS_MEAN = 28
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MAX = 29
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN = 30
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MAX = 31
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN = 32
    BROKER_LOG_FLUSH_RATE = 33
    BROKER_LOG_FLUSH_TIME_MS_MAX = 34
    BROKER_LOG_FLUSH_TIME_MS_MEAN = 35
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_50TH = 36
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_999TH = 37
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_50TH = 38
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_999TH = 39
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_50TH = 40
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_999TH = 41
    BROKER_PRODUCE_TOTAL_TIME_MS_50TH = 42
    BROKER_PRODUCE_TOTAL_TIME_MS_999TH = 43
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_50TH = 44
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_999TH = 45
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_50TH = 46
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_999TH = 47
    BROKER_PRODUCE_LOCAL_TIME_MS_50TH = 48
    BROKER_PRODUCE_LOCAL_TIME_MS_999TH = 49
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_50TH = 50
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_999TH = 51
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_50TH = 52
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_999TH = 53
    BROKER_LOG_FLUSH_TIME_MS_50TH = 54
    BROKER_LOG_FLUSH_TIME_MS_999TH = 55


NUM_COMMON_METRICS = 9  # the COMMON block above
NUM_BROKER_METRICS = len(KafkaMetricDef)

#: CPU_USAGE aggregates as AVG; DISK_USAGE as LATEST (a gauge, the reference
#: keeps the most recent size); everything else rate-like is AVG.
AGGREGATION_OF: Dict[KafkaMetricDef, AggregationFunction] = {
    d: (AggregationFunction.LATEST if d == KafkaMetricDef.DISK_USAGE else AggregationFunction.AVG)
    for d in KafkaMetricDef
}

#: Resource each def contributes to (None for telemetry-only defs), matching
#: KafkaMetricDef's resource column.
RESOURCE_OF: Dict[KafkaMetricDef, Optional[Resource]] = {
    KafkaMetricDef.CPU_USAGE: Resource.CPU,
    KafkaMetricDef.DISK_USAGE: Resource.DISK,
    KafkaMetricDef.LEADER_BYTES_IN: Resource.NW_IN,
    KafkaMetricDef.LEADER_BYTES_OUT: Resource.NW_OUT,
    KafkaMetricDef.REPLICATION_BYTES_IN_RATE: Resource.NW_IN,
    KafkaMetricDef.REPLICATION_BYTES_OUT_RATE: Resource.NW_OUT,
}

#: RawMetricType -> KafkaMetricDef, matching KafkaMetricDef.TYPE_TO_DEF (:125).
TYPE_TO_DEF: Dict[RawMetricType, KafkaMetricDef] = {
    # topic raw metrics -> common defs
    RawMetricType.TOPIC_BYTES_IN: KafkaMetricDef.LEADER_BYTES_IN,
    RawMetricType.TOPIC_BYTES_OUT: KafkaMetricDef.LEADER_BYTES_OUT,
    RawMetricType.TOPIC_REPLICATION_BYTES_IN: KafkaMetricDef.REPLICATION_BYTES_IN_RATE,
    RawMetricType.TOPIC_REPLICATION_BYTES_OUT: KafkaMetricDef.REPLICATION_BYTES_OUT_RATE,
    RawMetricType.TOPIC_PRODUCE_REQUEST_RATE: KafkaMetricDef.PRODUCE_RATE,
    RawMetricType.TOPIC_FETCH_REQUEST_RATE: KafkaMetricDef.FETCH_RATE,
    RawMetricType.TOPIC_MESSAGES_IN_PER_SEC: KafkaMetricDef.MESSAGE_IN_RATE,
    # partition raw metrics
    RawMetricType.PARTITION_SIZE: KafkaMetricDef.DISK_USAGE,
    # broker raw metrics
    RawMetricType.BROKER_CPU_UTIL: KafkaMetricDef.CPU_USAGE,
    RawMetricType.ALL_TOPIC_BYTES_IN: KafkaMetricDef.LEADER_BYTES_IN,
    RawMetricType.ALL_TOPIC_BYTES_OUT: KafkaMetricDef.LEADER_BYTES_OUT,
    RawMetricType.ALL_TOPIC_REPLICATION_BYTES_IN: KafkaMetricDef.REPLICATION_BYTES_IN_RATE,
    RawMetricType.ALL_TOPIC_REPLICATION_BYTES_OUT: KafkaMetricDef.REPLICATION_BYTES_OUT_RATE,
    RawMetricType.ALL_TOPIC_PRODUCE_REQUEST_RATE: KafkaMetricDef.PRODUCE_RATE,
    RawMetricType.ALL_TOPIC_FETCH_REQUEST_RATE: KafkaMetricDef.FETCH_RATE,
    RawMetricType.ALL_TOPIC_MESSAGES_IN_PER_SEC: KafkaMetricDef.MESSAGE_IN_RATE,
    RawMetricType.BROKER_PRODUCE_REQUEST_RATE: KafkaMetricDef.BROKER_PRODUCE_REQUEST_RATE,
    RawMetricType.BROKER_CONSUMER_FETCH_REQUEST_RATE: KafkaMetricDef.BROKER_CONSUMER_FETCH_REQUEST_RATE,
    RawMetricType.BROKER_FOLLOWER_FETCH_REQUEST_RATE: KafkaMetricDef.BROKER_FOLLOWER_FETCH_REQUEST_RATE,
    RawMetricType.BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT: KafkaMetricDef.BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT,
    RawMetricType.BROKER_REQUEST_QUEUE_SIZE: KafkaMetricDef.BROKER_REQUEST_QUEUE_SIZE,
    RawMetricType.BROKER_RESPONSE_QUEUE_SIZE: KafkaMetricDef.BROKER_RESPONSE_QUEUE_SIZE,
}

# remaining broker raw types map 1:1 by name
for _t in RawMetricType:
    if _t not in TYPE_TO_DEF and _t.name.startswith("BROKER_"):
        try:
            TYPE_TO_DEF[_t] = KafkaMetricDef[_t.name]
        except KeyError:
            pass

COMMON_METRIC_DEFS: List[KafkaMetricDef] = [d for d in KafkaMetricDef if d < NUM_COMMON_METRICS]
