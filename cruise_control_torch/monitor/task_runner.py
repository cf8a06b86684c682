"""Sampling scheduler: the LoadMonitorTaskRunner analog.

Mirrors cc/monitor/task/LoadMonitorTaskRunner.java:30 — a background scheduler
driving periodic sampling rounds against the LoadMonitor, plus the bootstrap
and training tasks (BootstrapTask :21, TrainingTask :20). The state machine
(NOT_STARTED/LOADING/RUNNING/SAMPLING/PAUSED/BOOTSTRAPPING/TRAINING,
enum :52) lives on the monitor; the runner drives the transitions and
exposes the combined view for `/state`.

Sampling itself may be a single `MetricSampler` or an N-way
`MetricFetcherManager` (monitor.fetcher) — the monitor treats both
identically through the sampler signature.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from cruise_control_torch.monitor.load_monitor import LoadMonitor
from cruise_control_torch.monitor.sampler import Samples


class LoadMonitorTaskRunner:
    def __init__(self, monitor: LoadMonitor, sampling_interval_s: Optional[float] = None):
        self._monitor = monitor
        self._interval = (
            sampling_interval_s
            if sampling_interval_s is not None
            else monitor._config.sampling_interval_s
        )
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # exclusive-mode serialization (one bootstrap/training at a time,
        # :127) lives on the monitor's _task_lock so REST requests that reach
        # the monitor directly are covered by the same guard
        self.sensors: Dict[str, int] = {
            "sampling_rounds": 0,
            "sampling_failures": 0,
            "bootstrap_tasks": 0,
            "training_tasks": 0,
        }

    @property
    def state(self) -> str:
        """The reference's LoadMonitorTaskRunnerState, surfaced via /state."""
        return self._monitor.state

    def start(self) -> None:
        """LoadMonitorTaskRunner.start (:225): replay store, begin sampling."""
        if self._thread is not None:
            raise RuntimeError("task runner already started")
        self._monitor.start_up()
        self._stop.clear()

        def run():
            while not self._stop.wait(self._interval):
                try:
                    self._monitor.sample_once()
                    self.sensors["sampling_rounds"] += 1
                except Exception:
                    self.sensors["sampling_failures"] += 1

        self._thread = threading.Thread(target=run, name="load-monitor-sampler", daemon=True)
        self._thread.start()

    # -- bootstrap (BootstrapTask) --------------------------------------------

    def bootstrap(self, samples: Samples) -> int:
        """Backfill pre-built samples."""
        self.sensors["bootstrap_tasks"] += 1
        return self._monitor.bootstrap(samples)

    def bootstrap_range(self, start_ms: int, end_ms: Optional[int] = None) -> int:
        """Time-range backfill from the sample store (RANGE / SINCE modes of
        LoadMonitorTaskRunner.bootstrap :127-177)."""
        self.sensors["bootstrap_tasks"] += 1
        return self._monitor.bootstrap_range(start_ms, end_ms)

    # -- training (TrainingTask) ----------------------------------------------

    def train(self, start_ms: int, end_ms: Optional[int] = None) -> Dict:
        """Feed the linear-regression CPU model from the range's broker
        samples (LoadMonitorTaskRunner.train :205)."""
        self.sensors["training_tasks"] += 1
        return self._monitor.train_range(start_ms, end_ms)

    # -- pause / resume --------------------------------------------------------

    def pause_sampling(self, reason: str = "") -> None:
        self._monitor.pause_metric_sampling(reason)

    def resume_sampling(self) -> None:
        self._monitor.resume_metric_sampling()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
