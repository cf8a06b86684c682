"""Goal registry: name -> singleton goal instance, in reference priority order.

Mirrors the default goal stack of cc/config/KafkaCruiseControlConfig.java:1287-1322
and the name resolution of KafkaCruiseControl.goalsByPriority (:1218): the
fifteen goals of the default stack, the two kafka-assigner goals (a
KafkaAssigner-prefixed request switches modes) and the preferred-leader
election of the demote flow (`elect_preferred_leaders`, K11).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from cruise_control_torch.analyzer.goals.base import Goal
from cruise_control_torch.analyzer.goals.hard import (
    CapacityGoal,
    RackAwareGoal,
    ReplicaCapacityGoal,
)
from cruise_control_torch.analyzer.goals.kafka_assigner import (
    KafkaAssignerDiskUsageDistributionGoal,
    KafkaAssignerEvenRackAwareGoal,
)
from cruise_control_torch.analyzer.goals.preferred import elect_preferred_leaders
from cruise_control_torch.analyzer.goals.soft import (
    LeaderBytesInDistributionGoal,
    LeaderReplicaDistributionGoal,
    PotentialNwOutGoal,
    ReplicaDistributionGoal,
    ResourceDistributionGoal,
    TopicReplicaDistributionGoal,
)
from cruise_control_torch.common.resources import Resource

#: Priority-ordered default stack (same order as the reference's default.goals).
DEFAULT_GOAL_ORDER: List[Goal] = [
    RackAwareGoal(),
    ReplicaCapacityGoal(),
    CapacityGoal(Resource.DISK),
    CapacityGoal(Resource.NW_IN),
    CapacityGoal(Resource.NW_OUT),
    CapacityGoal(Resource.CPU),
    ReplicaDistributionGoal(),
    PotentialNwOutGoal(),
    ResourceDistributionGoal(Resource.DISK),
    ResourceDistributionGoal(Resource.NW_IN),
    ResourceDistributionGoal(Resource.NW_OUT),
    ResourceDistributionGoal(Resource.CPU),
    TopicReplicaDistributionGoal(),
    LeaderReplicaDistributionGoal(),
    LeaderBytesInDistributionGoal(),
]

#: kafka-assigner mode goals: resolvable by name, excluded from the default
#: stack; a KafkaAssigner-prefixed request switches modes
#: (cc/KafkaCruiseControlUtils.java:193)
KAFKA_ASSIGNER_GOALS: List[Goal] = [
    KafkaAssignerEvenRackAwareGoal(),
    KafkaAssignerDiskUsageDistributionGoal(),
]

GOAL_REGISTRY: Dict[str, Goal] = {g.name: g for g in DEFAULT_GOAL_ORDER + KAFKA_ASSIGNER_GOALS}

HARD_GOAL_NAMES = [g.name for g in DEFAULT_GOAL_ORDER if g.is_hard]
SOFT_GOAL_NAMES = [g.name for g in DEFAULT_GOAL_ORDER if not g.is_hard]


def is_kafka_assigner_mode(names: Sequence[str] | None) -> bool:
    return bool(names) and any(n.rsplit(".", 1)[-1].startswith("KafkaAssigner") for n in names)


def get_goal(name: str) -> Goal:
    """Resolve a goal by simple or fully-qualified (Java or Python) name."""
    simple = name.rsplit(".", 1)[-1]
    if simple not in GOAL_REGISTRY:
        raise KeyError(f"unknown goal: {name!r} (known: {sorted(GOAL_REGISTRY)})")
    return GOAL_REGISTRY[simple]


def goals_by_priority(names: Sequence[str] | None = None) -> List[Goal]:
    """Requested goals in default-priority order; None = the full stack.

    KafkaAssigner-prefixed requests switch to kafka-assigner mode: those
    goals run in their own order, rack awareness first."""
    if names is None:
        return list(DEFAULT_GOAL_ORDER)
    wanted = {get_goal(n).name for n in names}
    if is_kafka_assigner_mode(names):
        non_assigner = [n for n in wanted if not n.startswith("KafkaAssigner")]
        if non_assigner:
            raise ValueError(
                f"cannot mix kafka-assigner and regular goals: {sorted(non_assigner)}"
            )
        return [g for g in KAFKA_ASSIGNER_GOALS if g.name in wanted]
    return [g for g in DEFAULT_GOAL_ORDER if g.name in wanted]


__all__ = [
    "Goal",
    "DEFAULT_GOAL_ORDER",
    "GOAL_REGISTRY",
    "HARD_GOAL_NAMES",
    "SOFT_GOAL_NAMES",
    "get_goal",
    "goals_by_priority",
    "elect_preferred_leaders",
]
