"""Test/simulation harness.

The analog of the reference's embedded-cluster integration tier
(AbstractKafkaIntegrationTestHarness, SURVEY.md §4 tier 5): an in-process
simulated cluster that produces real raw metrics through the reporter
transport and accepts executor operations, so the full
reporter -> monitor -> analyzer -> executor loop runs without Kafka.
`testing.chaos` streams perturbations into that loop mid-execution.
"""

from cruise_control_torch.testing.faults import FaultPlan, FaultRule
from cruise_control_torch.testing.simulator import SimulatedCluster

__all__ = ["FaultPlan", "FaultRule", "SimulatedCluster"]
