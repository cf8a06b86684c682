"""Balancing constraint: the analyzer's threshold bundle as kernel-ready arrays.

Mirrors cc/analyzer/BalancingConstraint.java:22-66 — per-resource balance
percentages, capacity thresholds, low-utilization thresholds, replica/leader/
topic-replica balance percentages, max replicas per broker, and the
self-healing distribution threshold multiplier — stored as numpy arrays indexed
by `Resource` so goal kernels can consume them without Python dict lookups.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cruise_control_torch.common.resources import NUM_RESOURCES, Resource

_RES_KEY = {
    Resource.CPU: "cpu",
    Resource.NW_IN: "network.inbound",
    Resource.NW_OUT: "network.outbound",
    Resource.DISK: "disk",
}


@dataclasses.dataclass(frozen=True)
class BalancingConstraint:
    #: balance margin per resource (>= 1.0); balanced iff util in [avg/x, avg*x]
    resource_balance_percentage: np.ndarray  # f32[4]
    #: usable fraction of capacity per resource (<= 1.0)
    capacity_threshold: np.ndarray  # f32[4]
    #: below this fraction of capacity a broker is "low utilization"
    low_utilization_threshold: np.ndarray  # f32[4]
    replica_balance_percentage: float = 1.10
    leader_replica_balance_percentage: float = 1.10
    topic_replica_balance_percentage: float = 3.00
    goal_violation_distribution_threshold_multiplier: float = 1.00
    max_replicas_per_broker: int = 10000

    @classmethod
    def from_config(cls, config) -> "BalancingConstraint":
        balance = np.ones(NUM_RESOURCES, dtype=np.float32)
        capacity = np.ones(NUM_RESOURCES, dtype=np.float32)
        low = np.zeros(NUM_RESOURCES, dtype=np.float32)
        for res in Resource:
            key = _RES_KEY[res]
            balance[res] = config.get_double(f"{key}.balance.threshold")
            capacity[res] = config.get_double(f"{key}.capacity.threshold")
            low[res] = config.get_double(f"{key}.low.utilization.threshold")
        return cls(
            resource_balance_percentage=balance,
            capacity_threshold=capacity,
            low_utilization_threshold=low,
            replica_balance_percentage=config.get_double("replica.count.balance.threshold"),
            leader_replica_balance_percentage=config.get_double("leader.replica.count.balance.threshold"),
            topic_replica_balance_percentage=config.get_double("topic.replica.count.balance.threshold"),
            goal_violation_distribution_threshold_multiplier=config.get_double(
                "goal.violation.distribution.threshold.multiplier"
            ),
            max_replicas_per_broker=config.get_long("max.replicas.per.broker"),
        )

    @classmethod
    def default(cls) -> "BalancingConstraint":
        return cls(
            resource_balance_percentage=np.full(NUM_RESOURCES, 1.10, dtype=np.float32),
            capacity_threshold=np.full(NUM_RESOURCES, 0.80, dtype=np.float32),
            low_utilization_threshold=np.zeros(NUM_RESOURCES, dtype=np.float32),
        )

    def with_multiplier_applied(self) -> "BalancingConstraint":
        """Thresholds relaxed for a run triggered by a goal violation: each
        distribution goal's balance margin widened by
        `goal.violation.distribution.threshold.multiplier`
        (cc/analyzer/goals/ResourceDistributionGoal.java
        balancePercentageWithMargin). The resource percentages stay float32
        arrays; the three scalar percentages are Python floats."""
        m = self.goal_violation_distribution_threshold_multiplier
        return dataclasses.replace(
            self,
            resource_balance_percentage=np.float32(1.0)
            + (self.resource_balance_percentage - np.float32(1.0)) * np.float32(m),
            replica_balance_percentage=1.0 + (self.replica_balance_percentage - 1.0) * m,
            leader_replica_balance_percentage=1.0 + (self.leader_replica_balance_percentage - 1.0) * m,
            topic_replica_balance_percentage=1.0 + (self.topic_replica_balance_percentage - 1.0) * m,
        )
