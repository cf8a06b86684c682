"""Anomaly vocabulary + fix contracts.

Analogs of core/detector/Anomaly.java:22 (`fix()` contract),
cc/detector/GoalViolations.java:76 (fix -> rebalance with self-healing
goals), cc/detector/BrokerFailures.java:75 (fix -> decommission), and the
notifier result vocabulary (AnomalyNotificationResult {FIX, CHECK, IGNORE},
AnomalyType)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Set


class AnomalyType(enum.IntEnum):
    GOAL_VIOLATION = 0
    BROKER_FAILURE = 1
    METRIC_ANOMALY = 2


class AnomalyNotificationResult(enum.IntEnum):
    FIX = 0
    CHECK = 1
    IGNORE = 2


class Anomaly:
    anomaly_type: AnomalyType

    def fix(self, facade) -> Optional[object]:
        """Apply the self-healing action through the facade; returns the
        operation result or None when nothing was done."""
        raise NotImplementedError

    def describe(self) -> Dict:
        raise NotImplementedError


@dataclasses.dataclass
class GoalViolations(Anomaly):
    """fixable[name] = the goal produced proposals; unfixable[name] = the goal
    raised OptimizationFailure during detection (GoalViolations.java)."""

    fixable_goals: List[str]
    unfixable_goals: List[str]
    anomaly_type = AnomalyType.GOAL_VIOLATION

    def fix(self, facade):
        if not self.fixable_goals:
            return None
        from cruise_control_torch.analyzer.context import OptimizationOptions

        return facade.rebalance(
            dryrun=False,
            options=OptimizationOptions(is_triggered_by_goal_violation=True),
            ignore_proposal_cache=True,
        )

    def describe(self) -> Dict:
        return {
            "anomalyType": self.anomaly_type.name,
            "fixableViolatedGoals": self.fixable_goals,
            "unfixableViolatedGoals": self.unfixable_goals,
        }


@dataclasses.dataclass
class BrokerFailures(Anomaly):
    """failed_brokers: broker index -> failure time ms."""

    failed_brokers: Dict[int, int]
    anomaly_type = AnomalyType.BROKER_FAILURE

    def fix(self, facade):
        if not self.failed_brokers:
            return None
        return facade.decommission_brokers(set(self.failed_brokers), dryrun=False)

    def describe(self) -> Dict:
        return {
            "anomalyType": self.anomaly_type.name,
            "failedBrokers": {str(k): v for k, v in self.failed_brokers.items()},
        }


@dataclasses.dataclass
class ProposalDriftAnomaly(Anomaly):
    """The executor aborted a proposal batch because the cluster drifted too
    far from the batch's model (generation skew past
    `executor.proposal.max.generation.skew`, docs/RESILIENCE.md). The stale
    plan is gone; the fix is a fresh one — ride the INCREMENTAL lane
    (analyzer/incremental.py): derive the drift as typed model deltas,
    scatter them into the device-resident padded context of the last solve,
    and re-solve only the sensitivity-affected goals, seeded from the
    surviving placement. The facade falls back to the full goal-violation
    rebalance (same cache-bypassing path a violated goal triggers) when the
    lane reports a typed fallback reason, so breakers, enables, and the
    busy-executor gate still apply on both lanes."""

    drift: Dict
    anomaly_type = AnomalyType.GOAL_VIOLATION

    def fix(self, facade):
        incremental = getattr(facade, "incremental_reproposal", None)
        if incremental is not None:
            return incremental(dryrun=False)
        # Facade without the incremental surface: ride the classic
        # cache-bypassing goal-violation rebalance directly.
        from cruise_control_torch.analyzer.context import OptimizationOptions

        return facade.rebalance(
            dryrun=False,
            options=OptimizationOptions(is_triggered_by_goal_violation=True),
            ignore_proposal_cache=True,
        )

    def describe(self) -> Dict:
        return {
            "anomalyType": self.anomaly_type.name,
            "kind": "PROPOSAL_DRIFT",
            "drift": dict(self.drift),
        }


@dataclasses.dataclass
class MetricAnomaly(Anomaly):
    """One broker metric out of its historical band. Fix is a no-op, matching
    KafkaMetricAnomaly's TODO fix (cc/detector/KafkaMetricAnomaly.java)."""

    broker_index: int
    metric_name: str
    current_value: float
    threshold: float
    description: str = ""
    anomaly_type = AnomalyType.METRIC_ANOMALY

    def fix(self, facade):
        return None

    def describe(self) -> Dict:
        return {
            "anomalyType": self.anomaly_type.name,
            "broker": self.broker_index,
            "metric": self.metric_name,
            "value": self.current_value,
            "threshold": self.threshold,
            "description": self.description,
        }
