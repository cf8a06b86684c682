"""Test/simulation harness.

The analog of the reference's embedded-cluster integration tier
(AbstractKafkaIntegrationTestHarness, SURVEY.md §4 tier 5): an in-process
simulated cluster that produces real raw metrics through the reporter
transport, so the reporter -> monitor -> analyzer loop runs without Kafka.
The JAX package's fault plans and executor surfaces come with the executor.
"""

from cruise_control_torch.testing.simulator import SimulatedCluster

__all__ = ["SimulatedCluster"]
