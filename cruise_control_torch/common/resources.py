"""Resource and metric taxonomy.

Mirrors the semantics of the reference's `Resource` enum
(cc/common/Resource.java:17-21: CPU, NW_IN, NW_OUT, DISK with per-resource
epsilons and host-level flag for CPU) and the derived-resource axes of
`RawAndDerivedResource` (cc/model/RawAndDerivedResource.java), re-expressed as
integer indices into dense arrays so that every goal kernel can address loads by
constant axis instead of enum dispatch.

The per-partition load layout (`PartMetric`) captures what the reference's
`Load` object holds per replica, split by leadership, so broker loads reduce to
one segment-sum over replica slots:

  leader  contribution = [CPU_LEADER,   NW_IN_LEADER,   NW_OUT_LEADER, DISK]
  follower contribution = [CPU_FOLLOWER, NW_IN_FOLLOWER, 0,            DISK]

matching `ClusterModel.relocateLeadership` (cc/model/ClusterModel.java:307-339):
moving leadership transfers the whole NW_OUT plus the leadership CPU fraction,
while DISK follows the replica and NW_IN has distinct leader (produce) vs
follower (replication) rates.
"""

from __future__ import annotations

import enum

import numpy as np


class Resource(enum.IntEnum):
    """Balanced resources, same order/ids as the reference's Resource enum."""

    CPU = 0
    NW_IN = 1
    NW_OUT = 2
    DISK = 3


NUM_RESOURCES = 4

#: Per-resource epsilon used for utilization comparisons, mirroring the
#: reference's Resource epsilon concept (cc/common/Resource.java).
RESOURCE_EPSILON = np.array([1e-4, 1e-2, 1e-2, 1e-2], dtype=np.float32)

#: CPU capacity is accounted at host level in the reference
#: (cc/common/Resource.java:18, CapacityGoal host-level checks).
IS_HOST_RESOURCE = np.array([True, False, False, False])


class PartMetric(enum.IntEnum):
    """Columns of the per-partition load matrix `part_load: f32[P, M]`."""

    CPU_LEADER = 0  # leadership CPU share (ModelUtils.estimateLeaderCpuUtil)
    CPU_FOLLOWER = 1  # follower CPU (ModelUtils.getFollowerCpuUtilFromLeaderLoad)
    NW_IN_LEADER = 2  # produce bytes-in on the leader
    NW_IN_FOLLOWER = 3  # replication bytes-in on each follower
    NW_OUT_LEADER = 4  # bytes-out on the leader (consumers); 0 on followers
    DISK = 5  # partition size, identical on every replica


NUM_PART_METRICS = 6


class BrokerState(enum.IntEnum):
    """Broker liveness/lifecycle, mirroring cc/model/Broker.java:34."""

    ALIVE = 0
    NEW = 1
    DEMOTED = 2
    DEAD = 3


class ActionType(enum.IntEnum):
    """Balancing action vocabulary, mirroring cc/analyzer/ActionType.java:24."""

    INTER_BROKER_REPLICA_MOVEMENT = 0
    LEADERSHIP_MOVEMENT = 1
    INTER_BROKER_REPLICA_SWAP = 2


class ActionAcceptance(enum.IntEnum):
    """Mirrors cc/analyzer/ActionAcceptance.java:23."""

    ACCEPT = 0
    REPLICA_REJECT = 1
    BROKER_REJECT = 2
