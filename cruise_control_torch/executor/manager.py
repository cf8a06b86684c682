"""In-flight task bookkeeping with per-broker concurrency caps.

Analog of ExecutionTaskManager (cc/executor/ExecutionTaskManager.java):
enforces `num.concurrent.partition.movements.per.broker` and the global
leadership-movement batch size, and feeds state counts to the tracker.
"""

from __future__ import annotations

from typing import Dict, List, Set

from cruise_control_torch.executor.task import ExecutionTask, TaskState, TaskType
from cruise_control_torch.executor.tracker import ExecutionTaskTracker


class ExecutionTaskManager:
    def __init__(
        self,
        concurrent_partition_movements_per_broker: int = 10,
        max_leadership_movements: int = 1000,
    ):
        self._per_broker_cap = concurrent_partition_movements_per_broker
        self._leadership_cap = max_leadership_movements
        self._in_flight_by_broker: Dict[int, int] = {}
        self._in_flight: List[ExecutionTask] = []
        self.tracker = ExecutionTaskTracker()

    def set_concurrency(self, per_broker: int = None, leadership: int = None) -> None:
        """Dynamic throttle adjustment (Executor setters :356-372)."""
        if per_broker is not None:
            self._per_broker_cap = per_broker
        if leadership is not None:
            self._leadership_cap = leadership

    @property
    def leadership_cap(self) -> int:
        return self._leadership_cap

    def available_slots(self, brokers) -> Dict[int, int]:
        return {
            b: max(0, self._per_broker_cap - self._in_flight_by_broker.get(b, 0))
            for b in brokers
        }

    def mark_in_progress(self, tasks: List[ExecutionTask], now_ms: int = 0) -> None:
        for t in tasks:
            t.in_progress(now_ms)
            self._in_flight.append(t)
            if t.task_type == TaskType.INTER_BROKER_REPLICA_ACTION:
                for b in t.involved_brokers:
                    self._in_flight_by_broker[b] = self._in_flight_by_broker.get(b, 0) + 1
            self.tracker.observe(t)

    def mark_done(self, task: ExecutionTask) -> None:
        """Call after the task reached a terminal state."""
        if task in self._in_flight:
            self._in_flight.remove(task)
            if task.task_type == TaskType.INTER_BROKER_REPLICA_ACTION:
                for b in task.involved_brokers:
                    self._in_flight_by_broker[b] = max(0, self._in_flight_by_broker.get(b, 0) - 1)
        self.tracker.observe(task)

    @property
    def in_flight_tasks(self) -> List[ExecutionTask]:
        return list(self._in_flight)
