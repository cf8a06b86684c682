"""Replica movement ordering strategies.

Analog of cc/executor/strategy/: a strategy orders each broker's pending
inter-broker movement tasks; strategies chain, with the base
execution-id order as the final tie-breaker
(ExecutionTaskPlanner ctor chains BaseReplicaMovementStrategy last).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from cruise_control_torch.executor.task import ExecutionTask


class ReplicaMovementStrategy:
    """SPI (cc/executor/strategy/ReplicaMovementStrategy.java:15)."""

    def sort_key(self, task: ExecutionTask, urp: Optional[set] = None):
        """Smaller sorts first. `urp` is the set of currently
        under-replicated partition ids (for the URP strategy)."""
        raise NotImplementedError

    def chain(self, next_strategy: "ReplicaMovementStrategy") -> "ReplicaMovementStrategy":
        return _ChainedStrategy(self, next_strategy)

    def apply(self, tasks: Sequence[ExecutionTask], urp: Optional[set] = None) -> List[ExecutionTask]:
        base_chained = self.chain(BaseReplicaMovementStrategy())
        return sorted(tasks, key=lambda t: base_chained.sort_key(t, urp))


class _ChainedStrategy(ReplicaMovementStrategy):
    def __init__(self, first: ReplicaMovementStrategy, second: ReplicaMovementStrategy):
        self._first = first
        self._second = second

    def sort_key(self, task, urp=None):
        k1 = self._first.sort_key(task, urp)
        k2 = self._second.sort_key(task, urp)
        k1 = k1 if isinstance(k1, tuple) else (k1,)
        k2 = k2 if isinstance(k2, tuple) else (k2,)
        return k1 + k2


class BaseReplicaMovementStrategy(ReplicaMovementStrategy):
    """Execution-id order (cc/executor/strategy/BaseReplicaMovementStrategy.java:15)."""

    def sort_key(self, task, urp=None):
        return (task.execution_id,)


class PrioritizeLargeReplicaMovementStrategy(ReplicaMovementStrategy):
    """Biggest data first, so the long pole starts immediately."""

    def sort_key(self, task, urp=None):
        return (-task.proposal.data_to_move_mb,)


class PrioritizeSmallReplicaMovementStrategy(ReplicaMovementStrategy):
    """Smallest data first, so many moves finish early."""

    def sort_key(self, task, urp=None):
        return (task.proposal.data_to_move_mb,)


class PostponeUrpReplicaMovementStrategy(ReplicaMovementStrategy):
    """Move replicas of currently under-replicated partitions first (their
    data is at risk), postponing healthy partitions — the semantics of
    cc/executor/strategy/PostponeUrpReplicaMovementStrategy (healthy sorts
    after URP)."""

    def sort_key(self, task, urp=None):
        is_urp = urp is not None and task.proposal.partition in urp
        return (0 if is_urp else 1,)
