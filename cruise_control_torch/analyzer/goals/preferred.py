"""PreferredLeaderElectionGoal: leadership back to the preferred replica.

The reference utility goal (cc/analyzer/goals/PreferredLeaderElectionGoal.java:33)
makes replica position 0 the leader everywhere, skipping replicas on dead or
demoted brokers; the demote flow uses it (cc/KafkaCruiseControl.demoteBrokers
:434-474). In the flat model slot order is the preference order and slot 0
the leader, so for each partition whose leader sits on a demoted or dead
broker the lowest slot on an eligible broker is promoted: one pass, K11
(kernels.elect_preferred), as the JAX package's goals/preferred.py.
"""

from __future__ import annotations

import torch

from cruise_control_torch.analyzer.context import StaticCtx
from cruise_control_torch.kernels.elect_preferred import elect_preferred


def elect_preferred_leaders(static: StaticCtx, assignment: torch.Tensor) -> torch.Tensor:
    """i32[P, R] -> i32[P, R]: leadership moved off demoted and dead brokers
    (preferred.py:22). Partitions with no eligible replica keep their row
    (the caller reports them). The input is not written."""
    return elect_preferred(assignment.contiguous(), static.demoted, static.dead)
