"""Anomaly detection + self-healing.

Analog of cc/detector/ (SURVEY.md §2g): three detectors (goal violation,
broker failure, metric anomaly) feed a queue consumed by the anomaly handler,
which consults the notifier (FIX / CHECK / IGNORE) and triggers fixes through
the facade — goal violations rebalance, broker failures decommission.
"""

from cruise_control_torch.detector.anomalies import (
    Anomaly,
    AnomalyNotificationResult,
    AnomalyType,
    BrokerFailures,
    GoalViolations,
    MetricAnomaly,
)
from cruise_control_torch.detector.notifier import (
    AnomalyNotifier,
    NoopNotifier,
    SelfHealingNotifier,
    WebhookNotifier,
)
from cruise_control_torch.detector.detectors import (
    BrokerFailureDetector,
    GoalViolationDetector,
    MetricAnomalyDetector,
    PercentileMetricAnomalyFinder,
)
from cruise_control_torch.detector.anomaly_detector import AnomalyDetector, AnomalyDetectorConfig

__all__ = [
    "Anomaly",
    "AnomalyDetector",
    "AnomalyDetectorConfig",
    "AnomalyNotificationResult",
    "AnomalyNotifier",
    "AnomalyType",
    "BrokerFailureDetector",
    "BrokerFailures",
    "GoalViolationDetector",
    "GoalViolations",
    "MetricAnomaly",
    "MetricAnomalyDetector",
    "NoopNotifier",
    "PercentileMetricAnomalyFinder",
    "SelfHealingNotifier",
    "WebhookNotifier",
]
