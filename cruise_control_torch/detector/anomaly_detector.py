"""Anomaly detector orchestrator.

Analog of AnomalyDetector (cc/detector/AnomalyDetector.java:46): schedules
the three detectors at the detection interval, queues anomalies, and runs the
handler (AnomalyHandlerTask :231) that consults the notifier — FIX calls
anomaly.fix() through the facade (skipped while the executor is busy, which
becomes a delayed CHECK), CHECK re-queues after the delay, IGNORE drops.
Tracks per-type counts for /state."""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional

from cruise_control_torch.detector.anomalies import (
    Anomaly,
    AnomalyNotificationResult,
    AnomalyType,
)
from cruise_control_torch.detector.detectors import (
    BrokerFailureDetector,
    GoalViolationDetector,
    MetricAnomalyDetector,
)
from cruise_control_torch.detector.notifier import AnomalyNotifier, SelfHealingNotifier


@dataclasses.dataclass(frozen=True)
class AnomalyDetectorConfig:
    detection_interval_s: float = 300.0  # anomaly.detection.interval.ms


class AnomalyDetector:
    def __init__(
        self,
        facade,
        notifier: Optional[AnomalyNotifier] = None,
        goal_violation_detector: Optional[GoalViolationDetector] = None,
        broker_failure_detector: Optional[BrokerFailureDetector] = None,
        metric_anomaly_detector: Optional[MetricAnomalyDetector] = None,
        config: AnomalyDetectorConfig = AnomalyDetectorConfig(),
        clock=time.time,
    ):
        self._facade = facade
        self._notifier = notifier or SelfHealingNotifier()
        self._gv = goal_violation_detector or GoalViolationDetector(facade)
        self._bf = broker_failure_detector or BrokerFailureDetector(
            facade._monitor._metadata, clock=clock
        )
        self._ma = metric_anomaly_detector or MetricAnomalyDetector(facade._monitor)
        self._config = config
        self._clock = clock
        self._queue: "queue.Queue[Anomaly]" = queue.Queue()
        self._counts: Dict[str, int] = {t.name: 0 for t in AnomalyType}
        self._fixes: Dict[str, int] = {t.name: 0 for t in AnomalyType}
        self._fix_failures: Dict[str, int] = {t.name: 0 for t in AnomalyType}
        self._recent: List[Dict] = []
        self._drift_notifications = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._register_breaker_gauge()
        # executor → detector drift channel: a batch aborted for generation
        # skew queues a recompute through the normal self-healing path
        set_listener = getattr(facade._executor, "set_drift_listener", None)
        if set_listener is not None:
            set_listener(self.on_proposal_drift)

    def on_proposal_drift(self, info: Dict) -> None:
        """Executor drift-abort callback: queue a ProposalDriftAnomaly so the
        recompute rides the anomaly handler (notifier gating, breakers, and
        the busy-executor delayed-CHECK all apply)."""
        from cruise_control_torch.common.oplog import op_log
        from cruise_control_torch.common.sensors import REGISTRY
        from cruise_control_torch.detector.anomalies import ProposalDriftAnomaly

        REGISTRY.meter("AnomalyDetector.proposal-drift-notifications").mark()
        self._drift_notifications += 1
        anomaly = ProposalDriftAnomaly(drift=dict(info))
        self._counts[anomaly.anomaly_type.name] += 1
        self._recent.append(anomaly.describe())
        self._recent = self._recent[-50:]
        self._queue.put(anomaly)
        op_log("Proposal drift notification queued for recompute: %s", info)

    def _register_breaker_gauge(self) -> None:
        """Expose breaker states on /metrics (0=closed, 1=half-open, 2=open);
        full snapshots ride /state. Guarded: only notifiers with breakers
        (SelfHealingNotifier and subclasses) report."""
        from cruise_control_torch.common.retry import CircuitBreaker
        from cruise_control_torch.common.sensors import REGISTRY

        import weakref

        ref = weakref.ref(self)

        def breaker_codes():
            det = ref()
            if det is None:
                return {}
            breakers = getattr(det._notifier, "breakers_state", None)
            if breakers is None:
                return {}
            return {
                name: CircuitBreaker.STATE_CODES.get(snap["state"], -1)
                for name, snap in breakers().items()
            }

        REGISTRY.gauge("AnomalyDetector.breaker-state", breaker_codes)

    # -- one detection round (callable directly; the loop just schedules it) ---

    def detect_once(self) -> int:
        """Run all three detectors, queue anomalies; returns queued count."""
        from cruise_control_torch.common.sensors import REGISTRY
        from cruise_control_torch.common.tracing import TRACER

        with TRACER.span("anomaly-sweep", kind="detector") as span, \
                REGISTRY.histogram("AnomalyDetector.detection-timer"):
            found: List[Anomaly] = []
            bf = self._bf.detect()
            if bf:
                found.append(bf)
            gv = self._gv.detect()
            if gv:
                found.append(gv)
            found.extend(self._ma.detect())
            for a in found:
                self._counts[a.anomaly_type.name] += 1
                self._recent.append(a.describe())
                self._recent = self._recent[-50:]
                self._queue.put(a)
            span.attributes["anomalies"] = len(found)
            return len(found)

    def handle_once(self, block_s: float = 0.0) -> Optional[str]:
        """Consume one queued anomaly (AnomalyHandlerTask); returns the action
        taken ('FIX'/'CHECK'/'IGNORE') or None when the queue is empty."""
        try:
            anomaly = self._queue.get(timeout=block_s) if block_s else self._queue.get_nowait()
        except queue.Empty:
            return None
        now_ms = int(self._clock() * 1000)
        # executor busy => delayed re-check, never a concurrent fix
        if self._facade._executor.has_ongoing_execution:
            self._requeue_later(anomaly, delay_s=1.0)
            return AnomalyNotificationResult.CHECK.name
        from cruise_control_torch.common.oplog import op_log
        from cruise_control_torch.common.tracing import TRACER

        # the span threads one trace id through the decision, the (possibly
        # long) self-healing fix, and every op_log line they emit
        with TRACER.span(
            "anomaly-handle", kind="detector",
            anomalyType=anomaly.anomaly_type.name,
        ) as span:
            result, delay_s = self._notifier.on_anomaly(anomaly, now_ms)
            span.attributes["decision"] = result.name
            op_log("Anomaly %s: notifier decided %s", anomaly, result.name)
            if result == AnomalyNotificationResult.FIX:
                from cruise_control_torch.common.sensors import REGISTRY

                record = getattr(self._notifier, "record_fix_result", None)
                type_name = anomaly.anomaly_type.name
                try:
                    anomaly.fix(self._facade)
                    self._fixes[type_name] += 1
                    op_log("Self-healing fix completed for %s", anomaly)
                    if record is not None:
                        record(anomaly.anomaly_type, True)
                except Exception as e:
                    # fix failures surface through executor/notifier state, but
                    # the audit trail must still record them — and they feed
                    # the type's circuit breaker (degraded mode)
                    self._fix_failures[type_name] += 1
                    REGISTRY.meter("AnomalyDetector.fix-failures").mark()
                    span.attributes["fixError"] = f"{type(e).__name__}: {e}"
                    op_log("Self-healing fix FAILED for %s: %r", anomaly, e)
                    if record is not None:
                        record(anomaly.anomaly_type, False)
            elif result == AnomalyNotificationResult.CHECK:
                self._requeue_later(anomaly, delay_s)
            return result.name

    def _requeue_later(self, anomaly: Anomaly, delay_s: float) -> None:
        t = threading.Timer(delay_s, lambda: self._queue.put(anomaly))
        t.daemon = True
        t.start()

    # -- background loop -------------------------------------------------------

    def start_detection(self) -> None:
        """AnomalyDetector.startDetection (:143)."""
        self._stop.clear()

        def detect_loop():
            while not self._stop.wait(self._config.detection_interval_s):
                try:
                    self.detect_once()
                except Exception:
                    pass

        def handle_loop():
            while not self._stop.is_set():
                try:
                    self.handle_once(block_s=1.0)
                except Exception:
                    pass

        for fn, name in ((detect_loop, "anomaly-detectors"), (handle_loop, "anomaly-handler")):
            th = threading.Thread(target=fn, name=name, daemon=True)
            th.start()
            self._threads.append(th)

    def shutdown(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=5)
        self._threads.clear()

    def state(self) -> Dict:
        out = {
            "selfHealingEnabled": self._notifier.self_healing_enabled(),
            "anomalyCounts": dict(self._counts),
            "fixesTriggered": dict(self._fixes),
            "fixFailures": dict(self._fix_failures),
            "recentAnomalies": list(self._recent),
            "queuedAnomalies": self._queue.qsize(),
            "proposalDriftNotifications": self._drift_notifications,
        }
        breakers = getattr(self._notifier, "breakers_state", None)
        if breakers is not None:
            out["selfHealingBreakers"] = breakers()
        return out
