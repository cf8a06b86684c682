"""The in-broker metrics agent loop.

Analog of CruiseControlMetricsReporter (mr/CruiseControlMetricsReporter.java:41):
every `reporting_interval_s` it walks a metric source (the Yammer-registry
analog — any callable returning the broker's current raw metrics) and
publishes the records through the transport. One reporter instance per
(simulated or real) broker.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

from cruise_control_torch.reporter.metrics import CruiseControlMetric
from cruise_control_torch.reporter.transport import MetricsTransport

#: A metric source returns the broker's current raw metrics, stamped by the
#: caller-supplied time (ms). The Yammer metrics walk equivalent.
MetricSource = Callable[[int], List[CruiseControlMetric]]


@dataclasses.dataclass(frozen=True)
class MetricsReporterConfig:
    """Key names mirror cruise.control.metrics.reporter.* where meaningful."""

    reporting_interval_s: float = 10.0


class MetricsReporter:
    def __init__(
        self,
        broker_id: int,
        source: MetricSource,
        transport: MetricsTransport,
        config: MetricsReporterConfig = MetricsReporterConfig(),
        clock: Callable[[], float] = time.time,
    ):
        self._broker_id = broker_id
        self._source = source
        self._transport = transport
        self._config = config
        self._clock = clock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def report_once(self) -> int:
        """One reporting round; returns the number of records published."""
        now_ms = int(self._clock() * 1000)
        metrics = self._source(now_ms)
        if metrics:
            self._transport.publish(metrics)
        return len(metrics)

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("reporter already started")
        self._stop.clear()

        def run():
            while not self._stop.wait(self._config.reporting_interval_s):
                try:
                    self.report_once()
                except Exception:  # keep the pump alive like the reference agent
                    pass

        self._thread = threading.Thread(target=run, name=f"metrics-reporter-{self._broker_id}", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
