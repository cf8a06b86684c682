"""Shared taxonomy (resources, metrics, broker states)."""
from cruise_control_torch.common.resources import (  # noqa: F401
    NUM_PART_METRICS,
    NUM_RESOURCES,
    ActionAcceptance,
    ActionType,
    BrokerState,
    PartMetric,
    Resource,
)
