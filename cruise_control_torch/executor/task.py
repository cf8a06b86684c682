"""Execution task state machine.

Analog of ExecutionTask (cc/executor/ExecutionTask.java:41):

    PENDING --> IN_PROGRESS --> COMPLETED
                     |--> ABORTING --> ABORTED
                     |--> ABORTING --> DEAD
                     |--> DEAD

with the same valid-transition table (:55-60).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional

from cruise_control_torch.analyzer.proposals import ExecutionProposal


class TaskType(enum.IntEnum):
    INTER_BROKER_REPLICA_ACTION = 0
    LEADER_ACTION = 1


class TaskState(enum.IntEnum):
    PENDING = 0
    IN_PROGRESS = 1
    ABORTING = 2
    ABORTED = 3
    DEAD = 4
    COMPLETED = 5


_VALID_TRANSFER = {
    TaskState.PENDING: {TaskState.IN_PROGRESS},
    TaskState.IN_PROGRESS: {TaskState.ABORTING, TaskState.DEAD, TaskState.COMPLETED},
    TaskState.ABORTING: {TaskState.ABORTED, TaskState.DEAD},
    TaskState.COMPLETED: set(),
    TaskState.DEAD: set(),
    TaskState.ABORTED: set(),
}


#: terminal states always carry an end_time_ms and fire the task's listener
TERMINAL_STATES = frozenset({TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD})


@dataclasses.dataclass
class ExecutionTask:
    execution_id: int
    proposal: ExecutionProposal
    task_type: TaskType
    state: TaskState = TaskState.PENDING
    start_time_ms: Optional[int] = None
    end_time_ms: Optional[int] = None
    #: why the task reached a terminal state ("", "deadline", "dispatch
    #: failure: ...", "driver unreachable", ...) — failure attribution for
    #: the execution summary and op_log
    terminal_reason: str = ""
    #: decision-provenance join key (`<ledger run id>/p<partition>`): which
    #: recorded optimization decision this task executes — carried into
    #: terminal events and drift-trim records so GET /explain answers both
    #: "why was this proposed" and "what happened to it". Empty when the
    #: batch had no recorded ledger.
    provenance_id: str = ""
    #: invoked once, with the task, when it enters a terminal state; the
    #: executor wires this to its ExecutorNotifier + tracker
    listener: Optional[Callable[["ExecutionTask"], None]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def _transfer(self, target: TaskState) -> None:
        if target not in _VALID_TRANSFER[self.state]:
            raise ValueError(f"illegal transition {self.state.name} -> {target.name}")
        self.state = target
        if target in TERMINAL_STATES and self.listener is not None:
            self.listener(self)

    def in_progress(self, now_ms: int = 0) -> None:
        self.start_time_ms = now_ms
        self._transfer(TaskState.IN_PROGRESS)

    def completed(self, now_ms: int = 0) -> None:
        self.end_time_ms = now_ms
        self._transfer(TaskState.COMPLETED)

    def abort(self, reason: str = "") -> None:
        if reason:
            self.terminal_reason = reason
        self._transfer(TaskState.ABORTING)

    def aborted(self, now_ms: int = 0, reason: str = "") -> None:
        self.end_time_ms = now_ms
        if reason:
            self.terminal_reason = reason
        self._transfer(TaskState.ABORTED)

    def kill(self, now_ms: int = 0, reason: str = "") -> None:
        self.end_time_ms = now_ms
        if reason:
            self.terminal_reason = reason
        self._transfer(TaskState.DEAD)

    @property
    def done(self) -> bool:
        return self.state in (TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD)

    #: brokers whose in-flight budget this task consumes (source + destination)
    @property
    def involved_brokers(self):
        p = self.proposal
        if self.task_type == TaskType.LEADER_ACTION:
            return {p.old_leader, p.new_leader}
        return set(p.replicas_to_add) | set(p.replicas_to_remove)
