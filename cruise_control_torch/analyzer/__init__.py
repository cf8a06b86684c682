"""Analyzer: goal kernels and the batched-greedy optimizer, in PyTorch.

Exports the JAX package's analyzer names. They load lazily, at first use
(a module `__getattr__`): the kernel modules import `analyzer.actions`,
which must not pull the optimizer in.
"""

import importlib

#: each exported name and the submodule that defines it
_EXPORTS = {
    "ClusterModelStats": "stats",
    "compute_stats": "stats",
    "ActionBatch": "actions",
    "BalancingAction": "actions",
    "GOAL_REGISTRY": "goals",
    "get_goal": "goals",
    "goals_by_priority": "goals",
    "GoalOptimizer": "optimizer",
    "OptimizerResult": "optimizer",
    "ExecutionProposal": "proposals",
    "proposal_diff": "proposals",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
