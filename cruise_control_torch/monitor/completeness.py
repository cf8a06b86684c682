"""Model completeness requirements.

Analog of ModelCompletenessRequirements (cc/monitor/ModelCompletenessRequirements.java:33)
with the weaker()/stronger() combinators used when merging per-goal
requirements (MonitorUtils.combineLoadRequirementOptions)."""

from __future__ import annotations

import dataclasses


class ModelCompletenessError(ValueError):
    """The monitor's windows cannot satisfy the requested completeness.

    A ValueError subclass so existing handlers keep working; the REST layer
    maps it to a typed 503 (`errorClass` + `completeness` detail) instead of
    a generic 500 — "not enough data yet" is a retryable service condition,
    not an internal failure. `completeness` carries the observed-vs-required
    numbers for the caller's backoff decision."""

    def __init__(self, message: str, completeness: dict):
        super().__init__(message)
        self.completeness = dict(completeness)


class NotEnoughValidWindowsError(ModelCompletenessError):
    """Fewer valid aggregation windows than min_required_num_windows."""


class NotEnoughValidPartitionsError(ModelCompletenessError):
    """Monitored-partition ratio below min_monitored_partitions_percentage."""


@dataclasses.dataclass(frozen=True)
class ModelCompletenessRequirements:
    min_required_num_windows: int = 1
    min_monitored_partitions_percentage: float = 0.995
    include_all_topics: bool = False

    def weaker(self, other: "ModelCompletenessRequirements") -> "ModelCompletenessRequirements":
        """The less demanding combination (satisfied if either would be)."""
        return ModelCompletenessRequirements(
            min_required_num_windows=min(
                self.min_required_num_windows, other.min_required_num_windows
            ),
            min_monitored_partitions_percentage=min(
                self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage,
            ),
            include_all_topics=self.include_all_topics and other.include_all_topics,
        )

    def stronger(self, other: "ModelCompletenessRequirements") -> "ModelCompletenessRequirements":
        """The more demanding combination (satisfies both)."""
        return ModelCompletenessRequirements(
            min_required_num_windows=max(
                self.min_required_num_windows, other.min_required_num_windows
            ),
            min_monitored_partitions_percentage=max(
                self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage,
            ),
            include_all_topics=self.include_all_topics or other.include_all_topics,
        )
