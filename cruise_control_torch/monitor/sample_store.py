"""Sample persistence SPI — the checkpoint/resume mechanism.

Analog of SampleStore (cc/monitor/sampling/SampleStore.java:17) and
KafkaSampleStore (cc/monitor/sampling/KafkaSampleStore.java:79): metric
samples are the ONLY durable state; windows are rebuilt by replaying them on
startup (SampleLoadingTask). The default here is an append-only local file
pair; a Kafka/object-store impl plugs in through the same SPI.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Iterable, List, Tuple

from cruise_control_torch.monitor.samples import (
    BrokerMetricSample,
    PartitionMetricSample,
    deserialize_sample,
    serialize_sample,
)


class SampleStore:
    def store_samples(
        self,
        partition_samples: Iterable[PartitionMetricSample],
        broker_samples: Iterable[BrokerMetricSample],
    ) -> None:
        raise NotImplementedError

    def load_samples(self) -> Tuple[List[PartitionMetricSample], List[BrokerMetricSample]]:
        """Replay everything retained (KafkaSampleStore.loadSamples :332)."""
        raise NotImplementedError

    def configure_retention(self, retention_ms: int) -> None:
        """Hint the aggregation horizon (window_ms * num_windows); stores
        that persist history may drop anything older. The LoadMonitor calls
        this at construction — the analog of KafkaSampleStore configuring
        its sample topics' retention to the horizon
        (cc/monitor/sampling/KafkaSampleStore.java:79)."""

    def close(self) -> None:
        pass


class NoopSampleStore(SampleStore):
    def store_samples(self, partition_samples, broker_samples) -> None:
        pass

    def load_samples(self):
        return [], []


class FileSampleStore(SampleStore):
    """Length-prefixed binary records in time-segmented append files with
    retention.

    KafkaSampleStore leans on topic retention to bound both storage and the
    startup replay (cc/monitor/sampling/KafkaSampleStore.java:79 configures
    the sample topics' retention to the aggregation horizon; loadSamples :332
    then replays whatever the broker kept). The file analog: records land in
    segment files named `<kind>-<segment_start_ms>.bin` (segment id = sample
    time // segment_ms), and segments that end before
    `newest sample time - retention_ms` are deleted on write and skipped —
    then deleted — on load. Replay cost is therefore bounded by
    retention_ms/segment_ms segments regardless of process uptime.

    `retention_ms=None` defers to `configure_retention`, which the
    LoadMonitor calls with its window_ms * num_windows horizon — samples
    older than the aggregation horizon can never contribute to a window, so
    dropping them loses nothing (same argument the reference makes for topic
    retention). An explicit constructor value wins over the monitor's hint.
    Legacy unsegmented `<kind>-samples.bin` files from older processes are
    still read (and counted as one always-retained segment)."""

    SEGMENT_DEFAULT_MS = 3_600_000  # 1h segments unless retention is tighter

    def __init__(self, directory: str, retention_ms: int | None = None,
                 segment_ms: int | None = None):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._retention = retention_ms
        self._retention_pinned = retention_ms is not None
        self._segment_ms_arg = segment_ms
        self._segment_ms = self._derive_segment_ms()
        self._max_time_ms = 0
        self._legacy = {
            "partition": os.path.join(directory, "partition-samples.bin"),
            "broker": os.path.join(directory, "broker-samples.bin"),
        }

    def _derive_segment_ms(self) -> int:
        if self._segment_ms_arg is not None:
            return self._segment_ms_arg
        segment_ms = self.SEGMENT_DEFAULT_MS
        if self._retention is not None:
            # >= 8 segments per horizon so expiry is reasonably granular
            segment_ms = min(segment_ms, max(1, self._retention // 8))
        return segment_ms

    def configure_retention(self, retention_ms: int) -> None:
        """Adopt the monitor's aggregation horizon unless the constructor
        pinned an explicit retention."""
        with self._lock:
            if self._retention_pinned:
                return
            self._retention = int(retention_ms)
            self._segment_ms = self._derive_segment_ms()

    def _segment_path(self, kind: str, time_ms: int) -> str:
        # the width is PERSISTED in the name: expiry must judge a segment by
        # the width it was WRITTEN with, not the current one — reopening a
        # directory after the retention hint (and hence the derived width)
        # shrinks would otherwise treat a wide old segment as expired while
        # it still holds in-retention samples
        start = (time_ms // self._segment_ms) * self._segment_ms
        return os.path.join(self._dir, f"{kind}-{start}w{self._segment_ms}.bin")

    def _segments(self, kind: str) -> List[Tuple[int, int, str]]:
        """[(segment_start_ms, width_ms, path)] for this kind, oldest first.

        Width-less names come from processes predating width persistence;
        their span is bounded conservatively by max(default, current width)
        (the derivation never exceeded the default unless explicitly
        constructed wider), which can only over-retain one segment."""
        out = []
        prefix = f"{kind}-"
        fallback = max(self.SEGMENT_DEFAULT_MS, self._segment_ms)
        for name in os.listdir(self._dir):
            if name.startswith(prefix) and name.endswith(".bin"):
                stem = name[len(prefix):-4]
                if stem.isdigit():
                    out.append((int(stem), fallback, os.path.join(self._dir, name)))
                elif "w" in stem:
                    start, _, width = stem.partition("w")
                    if start.isdigit() and width.isdigit():
                        out.append((int(start), int(width), os.path.join(self._dir, name)))
        return sorted(out)

    def _append(self, kind: str, samples) -> None:
        by_path: dict = {}
        for s in samples:
            payload = serialize_sample(s)
            by_path.setdefault(self._segment_path(kind, s.time_ms), []).append(payload)
            if s.time_ms > self._max_time_ms:
                self._max_time_ms = s.time_ms
        for path, payloads in by_path.items():
            with open(path, "ab") as f:
                for payload in payloads:
                    f.write(len(payload).to_bytes(4, "big") + payload)

    def _cutoff_ms(self) -> int | None:
        if self._retention is None:
            return None
        return self._max_time_ms - self._retention

    def _expire(self, kind: str) -> None:
        cutoff = self._cutoff_ms()
        if cutoff is None:
            return
        for start, width, path in self._segments(kind):
            if start + width <= cutoff:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def store_samples(self, partition_samples, broker_samples) -> None:
        with self._lock:
            self._append("partition", partition_samples)
            self._append("broker", broker_samples)
            self._expire("partition")
            self._expire("broker")

    def _read(self, path: str) -> List:
        out = []
        try:
            with open(path, "rb") as f:
                while True:
                    head = f.read(4)
                    if len(head) < 4:
                        break
                    size = int.from_bytes(head, "big")
                    payload = f.read(size)
                    if len(payload) < size:
                        break  # torn tail from a crash mid-append: stop here
                    try:
                        out.append(deserialize_sample(payload))
                    except (ValueError, struct.error):
                        break  # corrupt tail record; keep what was readable
        except FileNotFoundError:
            pass
        return out

    def _load_kind(self, kind: str) -> List:
        out = self._read(self._legacy[kind])
        segments = self._segments(kind)
        if out or segments:
            # estimate the newest sample time from segment STARTS — an
            # underestimate. Using segment ends would inflate the cutoff by
            # up to one segment and delete still-in-retention history at
            # restart; an underestimate only ever keeps one extra segment.
            newest = max(
                [s.time_ms for s in out] + [start for start, _, _ in segments]
                or [0]
            )
            if newest > self._max_time_ms:
                self._max_time_ms = newest
        cutoff = self._cutoff_ms()
        for start, width, path in segments:
            if cutoff is not None and start + width <= cutoff:
                try:
                    os.unlink(path)  # truncate on load: bounded restart replay
                except OSError:
                    pass
                continue
            out.extend(self._read(path))
        return out

    def load_samples(self):
        with self._lock:
            return self._load_kind("partition"), self._load_kind("broker")
