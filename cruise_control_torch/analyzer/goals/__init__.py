"""Goal registry: name -> singleton goal instance, in reference priority order.

Mirrors the default goal stack of cc/config/KafkaCruiseControlConfig.java:1287-1322
and the name resolution of KafkaCruiseControl.goalsByPriority (:1218). The six
hard goals are ported; the soft and kafka-assigner goals resolve by name as
`UnportedGoal`s, which the optimizer refuses (ROADMAP.md, Queue 1 item 3).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from cruise_control_torch.analyzer.goals.base import Goal, UnportedGoal
from cruise_control_torch.analyzer.goals.hard import (
    CapacityGoal,
    RackAwareGoal,
    ReplicaCapacityGoal,
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
    UnportedGoal("ReplicaDistributionGoal"),
    UnportedGoal("PotentialNwOutGoal"),
    UnportedGoal("DiskUsageDistributionGoal"),
    UnportedGoal("NetworkInboundUsageDistributionGoal"),
    UnportedGoal("NetworkOutboundUsageDistributionGoal"),
    UnportedGoal("CpuUsageDistributionGoal"),
    UnportedGoal("TopicReplicaDistributionGoal"),
    UnportedGoal("LeaderReplicaDistributionGoal"),
    UnportedGoal("LeaderBytesInDistributionGoal"),
]

#: kafka-assigner mode goals: resolvable by name, excluded from the default stack
KAFKA_ASSIGNER_GOALS: List[Goal] = [
    UnportedGoal("KafkaAssignerEvenRackAwareGoal", is_hard=True),
    UnportedGoal("KafkaAssignerDiskUsageDistributionGoal"),
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
    """Requested goals in default-priority order; None = the full stack."""
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
]
