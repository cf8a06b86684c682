"""Sample records + binary serde.

Analogs of PartitionMetricSample (cc/monitor/sampling/PartitionMetricSample.java)
and BrokerMetricSample (cc/monitor/sampling/BrokerMetricSample.java): one
timestamped dense metric vector per entity, with a versioned binary wire form
for the sample store."""

from __future__ import annotations

import dataclasses
import struct
from typing import List

import numpy as np

from cruise_control_torch.monitor.metricdef import NUM_BROKER_METRICS, NUM_COMMON_METRICS

SAMPLE_SERDE_VERSION = 1

# header: version u8, kind u8, entity i64, time i64, metric count u16
_HEADER = struct.Struct(">BBqqH")
_KIND_PARTITION = 0
_KIND_BROKER = 1


@dataclasses.dataclass(frozen=True)
class PartitionMetricSample:
    """Dense COMMON-metric vector for one partition at one time."""

    partition_id: int  # dense partition index
    time_ms: int
    metrics: np.ndarray  # f32[NUM_COMMON_METRICS]

    def __post_init__(self):
        if np.asarray(self.metrics).shape != (NUM_COMMON_METRICS,):
            raise ValueError(f"expected {NUM_COMMON_METRICS} common metrics")


@dataclasses.dataclass(frozen=True)
class BrokerMetricSample:
    """Dense full-metric vector for one broker at one time."""

    broker_id: int
    time_ms: int
    metrics: np.ndarray  # f32[NUM_BROKER_METRICS]

    def __post_init__(self):
        if np.asarray(self.metrics).shape != (NUM_BROKER_METRICS,):
            raise ValueError(f"expected {NUM_BROKER_METRICS} broker metrics")


def serialize_sample(s) -> bytes:
    kind = _KIND_PARTITION if isinstance(s, PartitionMetricSample) else _KIND_BROKER
    entity = s.partition_id if kind == _KIND_PARTITION else s.broker_id
    m = np.asarray(s.metrics, dtype=np.float32)
    return _HEADER.pack(SAMPLE_SERDE_VERSION, kind, entity, s.time_ms, m.shape[0]) + m.tobytes()


def deserialize_sample(data: bytes):
    version, kind, entity, time_ms, n = _HEADER.unpack_from(data, 0)
    if version > SAMPLE_SERDE_VERSION:
        raise ValueError(f"unsupported sample serde version {version}")
    metrics = np.frombuffer(data, dtype=np.float32, count=n, offset=_HEADER.size).copy()
    if kind == _KIND_PARTITION:
        return PartitionMetricSample(entity, time_ms, metrics)
    return BrokerMetricSample(entity, time_ms, metrics)


@dataclasses.dataclass
class SampleBatch:
    """Array-native batch of samples — the hot-path form.

    The processor emits these directly so a 200k-partition sampling round
    never materializes per-sample objects; `__iter__` lazily yields
    PartitionMetricSample/BrokerMetricSample only where an SPI needs records
    (file persistence, tests).
    """

    ids: np.ndarray  # i64[N]
    times: np.ndarray  # i64[N]
    metrics: np.ndarray  # f32[N, M]
    kind: str = "partition"  # "partition" | "broker"

    def __len__(self) -> int:
        return int(self.ids.shape[0])

    def __iter__(self):
        cls = PartitionMetricSample if self.kind == "partition" else BrokerMetricSample
        for i in range(len(self)):
            yield cls(int(self.ids[i]), int(self.times[i]), self.metrics[i])

    @classmethod
    def empty(cls, num_metrics: int, kind: str = "partition") -> "SampleBatch":
        return cls(
            np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros((0, num_metrics), np.float32), kind,
        )

    @classmethod
    def from_samples(cls, samples: List, kind: str = "partition") -> "SampleBatch":
        if not samples:
            m = NUM_COMMON_METRICS if kind == "partition" else NUM_BROKER_METRICS
            return cls.empty(m, kind)
        ids, times, metrics = batch_arrays(samples)
        return cls(ids, times, metrics, kind)


def as_batch(samples, kind: str = "partition") -> SampleBatch:
    """Normalize a list of sample records or a SampleBatch to a SampleBatch."""
    if isinstance(samples, SampleBatch):
        return samples
    return SampleBatch.from_samples(list(samples), kind)


def batch_arrays(samples: List) -> tuple:
    """(entity_ids i64[N], times i64[N], metrics f32[N, M]) for the aggregator."""
    if not samples:
        return (
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.zeros((0, NUM_COMMON_METRICS), np.float32),
        )
    ids = np.asarray(
        [s.partition_id if isinstance(s, PartitionMetricSample) else s.broker_id for s in samples],
        dtype=np.int64,
    )
    times = np.asarray([s.time_ms for s in samples], dtype=np.int64)
    metrics = np.stack([np.asarray(s.metrics, dtype=np.float32) for s in samples])
    return ids, times, metrics
