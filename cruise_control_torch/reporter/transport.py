"""Metric transport SPI — the `__CruiseControlMetrics` topic analog.

The reference moves raw metrics broker -> monitor through a Kafka topic
(mr/CruiseControlMetricsReporter.java:110-128 producer side;
cc/monitor/sampling/CruiseControlMetricsReporterSampler.java:100 consumer
side). The SPI below decouples the agent from the wire: an in-memory queue for
tests/embedded use, a JSONL file transport for durable local runs, and any
user impl (a real Kafka client would subclass MetricsTransport).
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import List, Optional

from cruise_control_torch.reporter.metrics import (
    CruiseControlMetric,
    RawMetricType,
    deserialize_metric,
    serialize_metric,
)


class MetricsTransport:
    """Producer+consumer contract for raw metric records."""

    def publish(self, metrics: List[CruiseControlMetric]) -> None:
        raise NotImplementedError

    def poll(self, max_records: int = 10000) -> List[CruiseControlMetric]:
        """Consume up to max_records pending metrics (at-most-once)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryTransport(MetricsTransport):
    """Thread-safe bounded queue; the embedded-cluster test analog."""

    def __init__(self, max_pending: int = 1_000_000):
        self._q: collections.deque = collections.deque(maxlen=max_pending)
        self._lock = threading.Lock()

    def publish(self, metrics: List[CruiseControlMetric]) -> None:
        with self._lock:
            self._q.extend(metrics)

    def poll(self, max_records: int = 10000) -> List[CruiseControlMetric]:
        out = []
        with self._lock:
            while self._q and len(out) < max_records:
                out.append(self._q.popleft())
        return out


class JsonlFileTransport(MetricsTransport):
    """Append-only JSONL file with a persisted consumer offset.

    Survives restarts the way the reference's Kafka topic does; the offset
    file plays the consumer-group-offset role.
    """

    def __init__(self, path: str):
        self._path = path
        self._offset_path = path + ".offset"
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def publish(self, metrics: List[CruiseControlMetric]) -> None:
        with self._lock, open(self._path, "ab") as f:
            for m in metrics:
                f.write(serialize_metric(m).hex().encode() + b"\n")

    def _read_offset(self) -> int:
        try:
            with open(self._offset_path) as f:
                return int(f.read().strip() or 0)
        except FileNotFoundError:
            return 0

    def poll(self, max_records: int = 10000) -> List[CruiseControlMetric]:
        with self._lock:
            offset = self._read_offset()
            out = []
            try:
                with open(self._path, "rb") as f:
                    f.seek(offset)
                    for _ in range(max_records):
                        line = f.readline()
                        if not line:
                            break
                        out.append(deserialize_metric(bytes.fromhex(line.strip().decode())))
                    new_offset = f.tell()
            except FileNotFoundError:
                return []
            with open(self._offset_path, "w") as f:
                f.write(str(new_offset))
            return out

    def replay_all(self) -> List[CruiseControlMetric]:
        """Re-read from the beginning without moving the consumer offset
        (bootstrap/backfill use; KafkaSampleStore.loadSamples analog)."""
        with self._lock:
            out = []
            try:
                with open(self._path, "rb") as f:
                    for line in f:
                        if line.strip():
                            out.append(deserialize_metric(bytes.fromhex(line.strip().decode())))
            except FileNotFoundError:
                pass
            return out


class TcpMetricsTransport(MetricsTransport):
    """Metrics over the cluster-agent wire protocol (executor/tcp_driver.py):
    the socket analog of the `__CruiseControlMetrics` topic for deployments
    where brokers reach the monitor through an agent rather than Kafka.

    Protocol ops (hex-encoded binary records, the serde is the wire format):
      {"op": "metrics_publish", "records": [hex, ...]} -> {"ok": true}
      {"op": "metrics_poll", "max": int}
          -> {"ok": true, "records": [hex, ...]}   (at-most-once consume)
    """

    def __init__(self, host: str, port: int, timeout_s: float = 10.0,
                 ssl_context=None, server_hostname: Optional[str] = None):
        from cruise_control_torch.executor.tcp_driver import _LineClient

        self._client = _LineClient(host, port, timeout_s, ssl_context=ssl_context,
                                   server_hostname=server_hostname)

    def publish(self, metrics: List[CruiseControlMetric]) -> None:
        # NOT retried on a mid-exchange drop: a re-send could double-count
        # the records agent-side; the reporter's next interval re-samples
        self._client.request({
            "op": "metrics_publish",
            "records": [serialize_metric(m).hex() for m in metrics],
        }, idempotent=False)

    def poll(self, max_records: int = 10000) -> List[CruiseControlMetric]:
        # NOT retried: a lost response already consumed its batch agent-side
        # (at-most-once, same stance as the in-memory transport)
        resp = self._client.request(
            {"op": "metrics_poll", "max": max_records}, idempotent=False
        )
        return [deserialize_metric(bytes.fromhex(r)) for r in resp.get("records", ())]

    def close(self) -> None:
        self._client.close()
