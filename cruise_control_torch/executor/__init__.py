"""Executor subsystem: apply proposals to the live cluster.

Analog of cc/executor/ (SURVEY.md §2f): the Executor drives proposals through
a ClusterDriver (the ZK/admin bridge SPI) in throttled batches — replica
movements first, then leadership — with per-broker concurrency caps, a task
state machine, pluggable movement-ordering strategies, and graceful
user-triggered stop. Metric sampling pauses during execution, exactly as
ProposalExecutionRunnable does (cc/executor/Executor.java:546-626).
"""

from cruise_control_torch.executor.task import ExecutionTask, TaskState, TaskType
from cruise_control_torch.executor.strategy import (
    BaseReplicaMovementStrategy,
    PostponeUrpReplicaMovementStrategy,
    PrioritizeLargeReplicaMovementStrategy,
    PrioritizeSmallReplicaMovementStrategy,
    ReplicaMovementStrategy,
)
from cruise_control_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_torch.executor.manager import ExecutionTaskManager
from cruise_control_torch.executor.tracker import ExecutionTaskTracker
from cruise_control_torch.executor.driver import ClusterDriver, SimulatorClusterDriver
from cruise_control_torch.executor.executor import Executor, ExecutorConfig, ExecutorState
from cruise_control_torch.executor.tcp_driver import TcpClusterDriver
from cruise_control_torch.executor.validation import (
    TopologyFingerprint,
    TopologyView,
    validate_proposal,
    validate_proposals,
)

__all__ = [
    "BaseReplicaMovementStrategy",
    "ClusterDriver",
    "ExecutionTask",
    "ExecutionTaskManager",
    "ExecutionTaskPlanner",
    "ExecutionTaskTracker",
    "Executor",
    "ExecutorConfig",
    "ExecutorState",
    "PostponeUrpReplicaMovementStrategy",
    "PrioritizeLargeReplicaMovementStrategy",
    "PrioritizeSmallReplicaMovementStrategy",
    "ReplicaMovementStrategy",
    "SimulatorClusterDriver",
    "TaskState",
    "TaskType",
    "TcpClusterDriver",
    "TopologyFingerprint",
    "TopologyView",
    "validate_proposal",
    "validate_proposals",
]
