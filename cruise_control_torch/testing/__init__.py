"""Test/simulation harness.

The analog of the reference's embedded-cluster integration tier
(AbstractKafkaIntegrationTestHarness, SURVEY.md §4 tier 5): an in-process
simulated cluster that produces real raw metrics through the reporter
transport and accepts executor operations, so the full
reporter -> monitor -> analyzer -> executor loop runs without Kafka.
`testing.chaos` streams perturbations into that loop mid-execution; the JAX
package's wire-level fault plans (testing/faults.py) come with the cluster
agent's wire (ROADMAP.md Queue 1 item 7, step 3b).
"""

from cruise_control_torch.testing.simulator import SimulatedCluster

__all__ = ["SimulatedCluster"]
