"""The three detectors.

- GoalViolationDetector (cc/detector/GoalViolationDetector.java:46): builds a
  fresh model and dry-runs each detection goal; proposals => fixable
  violation, hard-goal failure => unfixable; skips when dead brokers exist
  (that's the broker-failure detector's job, run :135-212).
- BrokerFailureDetector (cc/detector/BrokerFailureDetector.java:39): compares
  metadata liveness against brokers hosting replicas; persists failure times
  (failed.brokers.zk.path analog -> local JSON file) so failures survive
  restarts.
- MetricAnomalyDetector (cc/detector/MetricAnomalyDetector.java:26) with the
  percentile finder (core PercentileMetricAnomalyFinder): current broker
  metric outside [p_lower, p_upper] of its own history => anomaly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from cruise_control_torch.analyzer.optimizer import OptimizationFailureException
from cruise_control_torch.common.resources import BrokerState
from cruise_control_torch.detector.anomalies import BrokerFailures, GoalViolations, MetricAnomaly
from cruise_control_torch.monitor.metricdef import KafkaMetricDef


class GoalViolationDetector:
    def __init__(self, facade, detection_goals: Optional[Sequence[str]] = None):
        self._facade = facade
        self._goals = list(detection_goals) if detection_goals else None

    def detect(self) -> Optional[GoalViolations]:
        from cruise_control_torch.analyzer.goals import goals_by_priority

        try:
            with self._facade._monitor.acquire_for_model_generation():
                model, _ = self._facade._monitor.cluster_model()
        except ValueError:
            return None  # insufficient data; try next round
        if (np.asarray(model.broker_state) == BrokerState.DEAD).any():
            return None  # dead brokers are the broker-failure detector's job

        fixable: List[str] = []
        unfixable: List[str] = []
        optimizer = self._facade._optimizer
        for goal in goals_by_priority(self._goals):
            try:
                result = optimizer.optimizations(
                    model, goal_names=[goal.name], raise_on_hard_failure=True
                )
            except OptimizationFailureException:
                unfixable.append(goal.name)
                continue
            if result.proposals:
                fixable.append(goal.name)
        if fixable or unfixable:
            return GoalViolations(fixable_goals=fixable, unfixable_goals=unfixable)
        return None


class BrokerFailureDetector:
    """Liveness watcher with persisted failure times."""

    def __init__(self, metadata_client, persist_path: Optional[str] = None,
                 clock=None):
        import time as _time

        self._metadata = metadata_client
        self._path = persist_path
        self._clock = clock or _time.time
        self._lock = threading.Lock()
        self._failure_time_ms: Dict[int, int] = {}
        self._load()

    def _load(self) -> None:
        if self._path and os.path.exists(self._path):
            try:
                with open(self._path) as f:
                    self._failure_time_ms = {int(k): int(v) for k, v in json.load(f).items()}
            except (ValueError, OSError):
                self._failure_time_ms = {}

    def _persist(self) -> None:
        if self._path:
            with open(self._path, "w") as f:
                json.dump({str(k): v for k, v in self._failure_time_ms.items()}, f)

    def detect(self) -> Optional[BrokerFailures]:
        topo = self._metadata.refresh_metadata(force=True)
        hosts_replicas = np.zeros(topo.num_brokers, dtype=bool)
        a = np.asarray(topo.assignment)
        ids = a[a >= 0]
        hosts_replicas[ids[ids < topo.num_brokers]] = True
        dead = np.asarray(topo.broker_state) == BrokerState.DEAD
        now_ms = int(self._clock() * 1000)
        with self._lock:
            current = set(np.nonzero(dead & hosts_replicas)[0].tolist())
            for b in current:
                self._failure_time_ms.setdefault(int(b), now_ms)
            for b in list(self._failure_time_ms):
                if b not in current:
                    del self._failure_time_ms[b]  # broker recovered
            self._persist()
            if not self._failure_time_ms:
                return None
            return BrokerFailures(failed_brokers=dict(self._failure_time_ms))


@dataclasses.dataclass
class PercentileMetricAnomalyFinder:
    """core/detector/metricanomaly/PercentileMetricAnomalyFinder semantics:
    current value outside [lower_pct, upper_pct] of the broker's own history
    (requiring a minimum history) flags an anomaly."""

    upper_percentile: float = 95.0
    lower_percentile: float = 2.0
    min_history_windows: int = 3
    interested_metrics: Sequence[KafkaMetricDef] = (
        KafkaMetricDef.BROKER_PRODUCE_LOCAL_TIME_MS_MEAN,
        KafkaMetricDef.BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN,
        KafkaMetricDef.BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN,
        KafkaMetricDef.BROKER_LOG_FLUSH_TIME_MS_MEAN,
        KafkaMetricDef.BROKER_REQUEST_QUEUE_SIZE,
        KafkaMetricDef.BROKER_RESPONSE_QUEUE_SIZE,
    )

    def find(self, history: np.ndarray, current: np.ndarray) -> List[MetricAnomaly]:
        """history f32[B, W, M] (completed windows), current f32[B, M]."""
        out: List[MetricAnomaly] = []
        if history.shape[1] < self.min_history_windows:
            return out
        for m in self.interested_metrics:
            h = history[:, :, m].astype(np.float64)  # [B, W]
            # zero windows are absent data (NO_VALID_EXTRAPOLATION fills,
            # pre-join padding after a resize) — exclude them from the
            # baseline so they can't deflate the percentiles
            h_obs = np.where(h > 0, h, np.nan)
            n_obs = np.sum(~np.isnan(h_obs), axis=1)
            has_signal = n_obs >= self.min_history_windows
            with np.errstate(all="ignore"):
                upper = np.nanpercentile(h_obs, self.upper_percentile, axis=1)
                lower = np.nanpercentile(h_obs, self.lower_percentile, axis=1)
            upper = np.where(has_signal, upper, np.inf)
            lower = np.where(has_signal, lower, -np.inf)
            cur = current[:, m]
            too_high = has_signal & (cur > np.maximum(upper, 1e-9))
            too_low = has_signal & (cur < lower)
            for b in np.nonzero(too_high)[0]:
                out.append(
                    MetricAnomaly(
                        int(b), KafkaMetricDef(m).name, float(cur[b]), float(upper[b]),
                        f"value above P{self.upper_percentile:g} of history",
                    )
                )
            for b in np.nonzero(too_low)[0]:
                out.append(
                    MetricAnomaly(
                        int(b), KafkaMetricDef(m).name, float(cur[b]), float(lower[b]),
                        f"value below P{self.lower_percentile:g} of history",
                    )
                )
        return out


class MetricAnomalyDetector:
    def __init__(self, load_monitor, finder: Optional[PercentileMetricAnomalyFinder] = None):
        self._monitor = load_monitor
        self._finder = finder or PercentileMetricAnomalyFinder()

    def detect(self) -> List[MetricAnomaly]:
        agg = self._monitor._broker_agg
        try:
            result = agg.aggregate(include_current=False)
        except ValueError:
            return []
        values = result.values  # [B, W, M]
        if values.shape[1] < 2:
            return []
        history, current = values[:, :-1, :], values[:, -1, :]
        return self._finder.find(history, current)
