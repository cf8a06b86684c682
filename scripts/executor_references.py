"""chip_smoke.py's phase-19 references, computed on the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/executor_references.py

Runs phase 18's recipe on the JAX package (the smoke model's metrics through
chip_smoke.monitored_model, then the pinned bucketed service solve, held to
JAX_CPU_DIGESTS["monitored"]), then phase 19's: chip_smoke.stamp,
chip_smoke.execute_monitored on the simulator that emitted the metrics, a
second model build, and chip_smoke.chaos_run. Prints each run's
execution_record beside chip_smoke's JAX_CPU_EXECUTED / JAX_CPU_CHAOS, and
the host seconds of each step. About 8 minutes and 2 GB on 8 CPU cores; the
slow-lane test_torch_service.py::test_chip_smoke_jax_references_are_current
asserts the same records.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from cruise_control_tpu.analyzer import optimizer as jopt  # noqa: E402
from cruise_control_tpu.config import CruiseControlConfig  # noqa: E402
from cruise_control_tpu.executor import (  # noqa: E402
    Executor,
    ExecutorConfig,
    SimulatorClusterDriver,
    TopologyFingerprint,
)
from cruise_control_tpu.models import generators  # noqa: E402
from cruise_control_tpu.monitor.completeness import ModelCompletenessRequirements  # noqa: E402
from cruise_control_tpu.monitor.load_monitor import LoadMonitor, LoadMonitorConfig  # noqa: E402
from cruise_control_tpu.monitor.metadata import MetadataClient  # noqa: E402
from cruise_control_tpu.monitor.sampler import TransportMetricSampler  # noqa: E402
from cruise_control_tpu.reporter.transport import InMemoryTransport  # noqa: E402
from cruise_control_tpu.testing.chaos import ChaosHarness, ChaosPlan, Perturbation  # noqa: E402
from cruise_control_tpu.testing.simulator import SimulatedCluster  # noqa: E402
from test_torch_monitored_proposal import JAX_SERVICE  # noqa: E402


def main() -> int:
    ns = SimpleNamespace(
        SimulatedCluster=SimulatedCluster, InMemoryTransport=InMemoryTransport,
        MetadataClient=MetadataClient, TransportMetricSampler=TransportMetricSampler,
        LoadMonitor=LoadMonitor, LoadMonitorConfig=LoadMonitorConfig,
        ModelCompletenessRequirements=ModelCompletenessRequirements, Executor=Executor,
        ExecutorConfig=ExecutorConfig, SimulatorClusterDriver=SimulatorClusterDriver,
        TopologyFingerprint=TopologyFingerprint, CruiseControlConfig=CruiseControlConfig,
        ChaosHarness=ChaosHarness, ChaosPlan=ChaosPlan, Perturbation=Perturbation)
    model = generators.random_cluster(chip_smoke.SEED, dataclasses.replace(
        generators.BASELINE_CONFIGS[5], num_dead_brokers=26, load_distribution="pareto",
        mean_utilization=0.5))
    seconds = {}
    t0 = time.perf_counter()
    monitored, meta, _, _, sim, monitor = chip_smoke.monitored_model(model, ns)
    seconds["monitor"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**JAX_SERVICE)).optimizations(
        monitored, None, raise_on_hard_failure=False)
    seconds["solve"] = time.perf_counter() - t0
    digest = res.provenance.digest(goals=[g.name for g in res.goal_results])["checksum"]
    print(f"monitored solve digest {digest} "
          f"(chip_smoke: {chip_smoke.JAX_CPU_DIGESTS['monitored'][0]})")
    t0 = time.perf_counter()
    chip_smoke.stamp(res, monitor, meta, ns)
    seconds["stamp"] = time.perf_counter() - t0
    summary, batches, paused, seconds["execute"] = chip_smoke.execute_monitored(
        res, sim, monitor, ns)
    seconds["validation"] = summary["proposalValidation"]["overheadS"]
    after = np.asarray(sim.fetch_topology().assignment)
    executed = chip_smoke.execution_record(summary, after, batches)
    rebuilt, _ = monitor.cluster_model(ModelCompletenessRequirements(
        min_required_num_windows=1, min_monitored_partitions_percentage=0.5))
    victim, csummary, harness, seconds["chaos"] = chip_smoke.chaos_run(monitored, res, ns)
    chaos = chip_smoke.execution_record(csummary, np.asarray(harness.sim.fetch_topology()
                                                             .assignment))
    print(json.dumps({
        "executed": executed, "executed_equal": executed == chip_smoke.JAX_CPU_EXECUTED,
        "paused_at_every_dispatch": all(paused), "resumed": not monitor.sampling_paused,
        "rebuilt_holds_it": bool(np.array_equal(np.asarray(rebuilt.assignment), after)),
        "chaos": chaos, "chaos_equal": chaos == chip_smoke.JAX_CPU_CHAOS, "victim": victim,
        "violations": harness.checker.violations + harness.checker.check_final(),
        "host_seconds": seconds}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
