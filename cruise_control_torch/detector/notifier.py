"""Anomaly notifiers.

Analogs of cc/detector/notifier/: the AnomalyNotifier SPI maps each anomaly
to FIX / CHECK(delay) / IGNORE; SelfHealingNotifier
(SelfHealingNotifier.java:46) adds per-type self-healing enable flags and the
broker-failure grace-period state machine (alert threshold, then fix
threshold, onBrokerFailure :170); WebhookNotifier posts JSON to a callable
sink (the Slack webhook analog, egress-free).

Degraded mode (docs/RESILIENCE.md): each anomaly type carries a
CircuitBreaker. The anomaly handler reports every fix outcome back through
`record_fix_result`; after `breaker_threshold` consecutive failed fixes the
type's breaker opens and would-be FIX decisions degrade to delayed CHECKs
(delay = remaining cooldown) until the cooldown elapses, when one half-open
probe fix is admitted — success closes the breaker, failure re-opens it.
This stops a persistently failing fix (a wedged cluster, a bad goal config)
from being re-fired forever while keeping the anomaly on the queue."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from cruise_control_torch.common.retry import CircuitBreaker
from cruise_control_torch.detector.anomalies import (
    Anomaly,
    AnomalyNotificationResult,
    AnomalyType,
    BrokerFailures,
)


class AnomalyNotifier:
    def on_anomaly(self, anomaly: Anomaly, now_ms: int) -> Tuple[AnomalyNotificationResult, float]:
        """-> (result, check_delay_s when result is CHECK)."""
        raise NotImplementedError

    def self_healing_enabled(self) -> Dict[str, bool]:
        return {t.name: False for t in AnomalyType}


class NoopNotifier(AnomalyNotifier):
    def on_anomaly(self, anomaly, now_ms):
        return AnomalyNotificationResult.IGNORE, 0.0


@dataclasses.dataclass
class SelfHealingNotifier(AnomalyNotifier):
    """Per-type enables + broker-failure grace period.

    A failed broker first trips an alert after `broker_failure_alert_threshold_s`
    and is fixed only after `self_healing_threshold_s` (both measured from the
    failure time), giving transient bounces a chance to recover — the exact
    two-threshold ladder of SelfHealingNotifier.onBrokerFailure (:170)."""

    self_healing_goal_violation_enabled: bool = True
    self_healing_broker_failure_enabled: bool = True
    self_healing_metric_anomaly_enabled: bool = False
    broker_failure_alert_threshold_s: float = 900.0
    self_healing_threshold_s: float = 1800.0
    alert_sink: Optional[Callable[[Dict], None]] = None
    #: consecutive failed fixes of one anomaly type before its breaker opens
    #: (`selfhealing.breaker.threshold`)
    breaker_threshold: int = 3
    #: seconds the breaker stays open before a half-open probe fix
    #: (`selfhealing.breaker.cooldown.s`)
    breaker_cooldown_s: float = 300.0
    #: injectable monotonic clock (deterministic breaker tests)
    breaker_clock: Callable[[], float] = time.monotonic
    #: guarded_by(_lock)
    _breakers: Dict[str, CircuitBreaker] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, init=False, repr=False, compare=False
    )

    def _alert(self, payload: Dict) -> None:
        if self.alert_sink is not None:
            self.alert_sink(payload)

    # -- per-type circuit breakers ---------------------------------------------

    def breaker(self, anomaly_type: AnomalyType) -> CircuitBreaker:
        # get-or-create under the lock: the anomaly handler and the /state
        # server thread race here, and a duplicate breaker would silently
        # split the consecutive-failure count across two instances
        name = anomaly_type.name
        with self._lock:
            br = self._breakers.get(name)
            if br is None:
                br = self._breakers[name] = CircuitBreaker(
                    f"SelfHealing.{name}",
                    failure_threshold=self.breaker_threshold,
                    cooldown_s=self.breaker_cooldown_s,
                    clock=self.breaker_clock,
                )
        return br

    def record_fix_result(self, anomaly_type: AnomalyType, success: bool) -> None:
        """Fix outcome feedback from the anomaly handler."""
        br = self.breaker(anomaly_type)
        if success:
            br.record_success()
        else:
            br.record_failure()
            if br.state == CircuitBreaker.OPEN:
                self._alert({
                    "anomalyType": anomaly_type.name,
                    "selfHealingBreaker": br.snapshot(),
                })

    def breakers_state(self) -> Dict[str, Dict]:
        """Snapshot of every anomaly type's breaker (for /state)."""
        return {t.name: self.breaker(t).snapshot() for t in AnomalyType}

    def _gate_fix(self, anomaly_type: AnomalyType) -> Tuple[AnomalyNotificationResult, float]:
        """FIX if the type's breaker admits it; otherwise degrade to a
        delayed CHECK for the remaining cooldown (floor 1s so a CHECK is
        never an immediate-requeue busy loop)."""
        br = self.breaker(anomaly_type)
        if br.allow():
            return AnomalyNotificationResult.FIX, 0.0
        return AnomalyNotificationResult.CHECK, max(1.0, br.remaining_cooldown_s())

    def self_healing_enabled(self) -> Dict[str, bool]:
        return {
            AnomalyType.GOAL_VIOLATION.name: self.self_healing_goal_violation_enabled,
            AnomalyType.BROKER_FAILURE.name: self.self_healing_broker_failure_enabled,
            AnomalyType.METRIC_ANOMALY.name: self.self_healing_metric_anomaly_enabled,
        }

    def on_anomaly(self, anomaly: Anomaly, now_ms: int) -> Tuple[AnomalyNotificationResult, float]:
        t = anomaly.anomaly_type
        if t == AnomalyType.GOAL_VIOLATION:
            if self.self_healing_goal_violation_enabled:
                return self._gate_fix(t)
            return AnomalyNotificationResult.IGNORE, 0.0
        if t == AnomalyType.METRIC_ANOMALY:
            self._alert(anomaly.describe())
            if self.self_healing_metric_anomaly_enabled:
                return self._gate_fix(t)
            return AnomalyNotificationResult.IGNORE, 0.0
        # broker failure ladder
        assert isinstance(anomaly, BrokerFailures)
        if not anomaly.failed_brokers:
            return AnomalyNotificationResult.IGNORE, 0.0
        earliest_ms = min(anomaly.failed_brokers.values())
        alert_at = earliest_ms + self.broker_failure_alert_threshold_s * 1000
        fix_at = earliest_ms + self.self_healing_threshold_s * 1000
        if now_ms >= alert_at:
            self._alert({**anomaly.describe(), "autoFixTriggered": now_ms >= fix_at})
        if not self.self_healing_broker_failure_enabled:
            return AnomalyNotificationResult.IGNORE, 0.0
        if now_ms >= fix_at:
            return self._gate_fix(t)
        return AnomalyNotificationResult.CHECK, max(0.0, (fix_at - now_ms) / 1000.0)


class WebhookNotifier(SelfHealingNotifier):
    """Slack-style notifier: alerts render to a text payload and go to a
    `post` callable (an HTTP client in production; captured in tests) —
    cc/detector/notifier/SlackSelfHealingNotifier.java without the egress."""

    def __init__(self, post: Callable[[str], None], **kwargs):
        super().__init__(**kwargs)
        self._post = post
        self.alert_sink = self._to_text

    def _to_text(self, payload: Dict) -> None:
        kind = payload.get("anomalyType", "ANOMALY")
        self._post(f":warning: [{kind}] {payload}")
