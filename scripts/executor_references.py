"""chip_smoke.py's phase-19, phase-20, phase-21 and phase-23 references,
computed on the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/executor_references.py [--no-chaos] \
        [--served [--bodies PATH]]
    JAX_PLATFORMS=cpu python scripts/executor_references.py --mesh

--mesh runs phase 23's reference alone: the JAX package's greedy pass
(bench.py's greedy settings, the pinned schedule) of the bench's config-5
parity model on a mesh of 4 virtual CPU devices (the process is started
with XLA_FLAGS' host device count at 4), and prints its decision digest,
per-goal moves, final assignment SHA-256, goal rows and moves beside
chip_smoke's JAX_CPU_DIGESTS["mesh parity greedy"] and phase 9's
JAX_CPU_DIGESTS["parity greedy"] (about 2 minutes on 8 CPU cores).

Runs phase 18's recipe on the JAX package (the smoke model's metrics through
chip_smoke.monitored_model, then the pinned bucketed service solve, held to
JAX_CPU_DIGESTS["monitored"]), then phase 19's: chip_smoke.stamp,
chip_smoke.execute_monitored on the simulator that emitted the metrics, a
second model build, and chip_smoke.chaos_run (left out with --no-chaos);
then phase 20's, chip_smoke.self_healing on that simulator and monitor (a
broker killed, detected, decommissioned through the JAX facade and executed
over the TCP wire). Prints each run's execution_record beside chip_smoke's
JAX_CPU_EXECUTED / JAX_CPU_CHAOS, phase 20's record, decision digest, final
assignment SHA-256 and goal rows beside JAX_CPU_SELF_HEALING /
JAX_CPU_DIGESTS["broker failure"] / JAX_CPU_SELF_HEALING_REFERENCE, and the
host seconds of each step. With --served, then phase 21's:
chip_smoke.served on that simulator and monitor, the JAX service served by
its aiohttp server and driven by its client; prints the record
(chip_smoke.served_record) beside JAX_CPU_SERVED, each solve's digest, final
assignment SHA-256, goal rows and moves beside JAX_CPU_DIGESTS["served
..."], JAX_CPU_SERVED_REFERENCE and JAX_CPU_SERVED_MOVES, JAX's
elect_preferred_leaders on the demote's initial and final assignments beside
JAX_CPU_SERVED_K11_SHA256, and each request's host seconds; --bodies writes
the normalized bodies (chip_smoke.served_normalized) to PATH as JSON. About
12 minutes and 2 GB on 8 CPU cores without --served, and about twice that
with it; the slow-lane
test_torch_service.py::test_chip_smoke_jax_references_are_current asserts
the same records.
"""

import dataclasses
import hashlib
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

if "--mesh" in sys.argv:
    # four virtual CPU devices for the mesh, set before JAX starts
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()

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


def oversized(model, assignment, dead) -> dict:
    """Why the smoke model's capacity goals cannot be satisfied: the
    partitions whose disk load exceeds every broker's disk capacity, their
    largest ratio to it, and the alive brokers that hold one."""
    disk = np.asarray(model.part_load)[:, 5]
    cap = float(np.asarray(model.broker_capacity)[:, 3].max())
    big = disk > cap
    held = np.unique(assignment[big][assignment[big] >= 0])
    return {"partitions": int(big.sum()), "max_ratio": float(disk.max() / cap),
            "alive_brokers_holding_one": int(np.setdiff1d(held, dead).size)}


def aiohttp_serve(app):
    """Serve the JAX package's app on loopback with aiohttp on a thread:
    (url, stop)."""
    import asyncio
    import socket
    import threading

    from aiohttp import web

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    loop = asyncio.new_event_loop()
    started = threading.Event()
    runner = web.AppRunner(app.build_app())

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        started.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    started.wait(30)

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)

    return f"http://127.0.0.1:{port}", stop


def served_references(sim, monitor) -> dict:
    """Phase 21 on the JAX package: its record, each solve's digest, final
    assignment SHA-256, goal rows and moves, K11's SHA-256s on the demote's
    assignments and the requests' host seconds."""
    from cruise_control_tpu.analyzer.context import build_static_ctx, dims_of
    from cruise_control_tpu.analyzer.goals.preferred import elect_preferred_leaders
    from cruise_control_tpu.config.balancing import BalancingConstraint

    out = chip_smoke.served(sim, monitor, chip_smoke.package_classes(
        "cruise_control_tpu", chip_smoke.SERVED_CLASSES), aiohttp_serve)
    record = chip_smoke.served_record(out, sim)
    solves = {}
    for label, (model, res) in zip(("served proposals", "served rebalance", "served demote"),
                                   out["solves"]):
        names = [g.name for g in res.goal_results]
        dg = res.provenance.digest(goals=names)
        sha = hashlib.sha256(np.ascontiguousarray(res.final_assignment, dtype=np.int32)
                             .tobytes()).hexdigest()
        solves[label] = {
            "digest": [dg["checksum"], dg["byGoal"], sha],
            "digest_equal": (dg["checksum"], dg["byGoal"], sha) ==
            chip_smoke.JAX_CPU_DIGESTS.get(label),
            "reference": {g.name: [g.violated_brokers_before, g.violated_brokers_after, g.rounds,
                                   g.converged, float(f"{g.cost_before:.4g}"),
                                   float(f"{g.cost_after:.4g}")] for g in res.goal_results},
            "moves": {"replica": res.num_replica_moves, "leadership": res.num_leadership_moves}}
    model, res = out["solves"][2]
    cfg = chip_smoke.package_classes("cruise_control_tpu", chip_smoke.SERVED_CLASSES) \
        .CruiseControlConfig(chip_smoke.SELF_HEALING_CONFIG)
    st = build_static_ctx(model, BalancingConstraint.from_config(cfg), dims_of(model))
    k11 = {which: hashlib.sha256(np.ascontiguousarray(np.asarray(jax.jit(
        elect_preferred_leaders)(st, np.asarray(a))), dtype=np.int32).tobytes()).hexdigest()
        for which, a in (("initial", model.assignment), ("final", res.final_assignment))}
    return dict(served=record, served_equal=record == getattr(chip_smoke, "JAX_CPU_SERVED", None),
                served_solves=solves, served_k11_sha256=k11,
                served_seconds=out["seconds"], bodies={
                    k: chip_smoke.served_normalized(v) for k, v in out["bodies"].items()
                    if k != "metrics"})


def mesh_references() -> dict:
    """Phase 23 (b)'s reference: the parity model's greedy pass on a mesh of
    4 virtual CPU devices."""
    from cruise_control_tpu.parallel.sharding import make_mesh

    parity = generators.random_cluster(chip_smoke.SEED + 5, generators.ClusterProperty(
        num_racks=52, num_brokers=chip_smoke.PARITY_BROKERS,
        num_topics=max(50, (chip_smoke.PARITY_BROKERS * 20) // 13),
        mean_partitions_per_topic=50.0, replication_factor=3, load_distribution="exponential"))
    greedy = jopt.OptimizerSettings(
        batch_k=1, max_rounds_per_goal=512, num_dst_candidates=16, num_swap_pairs=16,
        swap_candidates=16, swaps_per_broker=4, chunk_rounds=64, cost_scaled_rounds=1.5,
        rounds_ceiling=4096, bucket_partitions=False, bucket_brokers=False,
        chunk_target_s=chip_smoke.PINNED_TARGET_S)
    t0 = time.perf_counter()
    res = jopt.GoalOptimizer(settings=greedy, mesh=make_mesh(4)).optimizations(
        parity, None, raise_on_hard_failure=False)
    seconds = time.perf_counter() - t0
    names = [g.name for g in res.goal_results]
    dg = res.provenance.digest(goals=names)
    sha = hashlib.sha256(np.ascontiguousarray(res.final_assignment, dtype=np.int32)
                         .tobytes()).hexdigest()
    record = (dg["checksum"], dg["byGoal"], sha)
    return {"partitions": parity.num_partitions, "mesh_parity_greedy": list(record),
            "equal_to_mesh_constant": record == chip_smoke.JAX_CPU_DIGESTS["mesh parity greedy"],
            "equal_to_phase_9": record == chip_smoke.JAX_CPU_DIGESTS["parity greedy"],
            "goals": {g.name: [g.violated_brokers_before, g.violated_brokers_after, g.rounds,
                               g.converged] for g in res.goal_results},
            "moves": {"replica": res.num_replica_moves,
                      "leadership": res.num_leadership_moves},
            "host_seconds": seconds}


def main() -> int:
    if "--mesh" in sys.argv:
        print(json.dumps(mesh_references(), indent=1))
        return 0
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
    out = {
        "executed": executed, "executed_equal": executed == chip_smoke.JAX_CPU_EXECUTED,
        "paused_at_every_dispatch": all(paused), "resumed": not monitor.sampling_paused,
        "rebuilt_holds_it": bool(np.array_equal(np.asarray(rebuilt.assignment), after))}
    if "--no-chaos" not in sys.argv:
        victim, csummary, harness, seconds["chaos"] = chip_smoke.chaos_run(monitored, res, ns)
        chaos = chip_smoke.execution_record(csummary, np.asarray(harness.sim.fetch_topology()
                                                                 .assignment))
        out.update(chaos=chaos, chaos_equal=chaos == chip_smoke.JAX_CPU_CHAOS, victim=victim,
                   violations=harness.checker.violations + harness.checker.check_final())
    healed = chip_smoke.self_healing(sim, monitor, chip_smoke.package_classes(
        "cruise_control_tpu", chip_smoke.SELF_HEALING_CLASSES))
    record = chip_smoke.self_healing_record(healed, sim)
    fix = healed["result"]
    names = [g.name for g in fix.goal_results]
    dg = fix.provenance.digest(goals=names)
    sha = hashlib.sha256(np.ascontiguousarray(fix.final_assignment, dtype=np.int32)
                         .tobytes()).hexdigest()
    final = np.asarray(sim.fetch_topology().assignment)
    dead = np.nonzero(np.asarray(sim.fetch_topology().broker_state) == 3)[0]
    seconds.update({f"self-healing {k}": v for k, v in healed["seconds"].items()})
    out.update(
        self_healing=record,
        self_healing_equal=record == getattr(chip_smoke, "JAX_CPU_SELF_HEALING", None),
        broker_failure_digest=[dg["checksum"], dg["byGoal"], sha],
        broker_failure_digest_equal=(dg["checksum"], dg["byGoal"], sha) ==
        chip_smoke.JAX_CPU_DIGESTS.get("broker failure"),
        broker_failure_reference={g.name: [g.violated_brokers_before, g.violated_brokers_after,
                                           g.rounds, g.converged, float(f"{g.cost_before:.4g}"),
                                           float(f"{g.cost_after:.4g}")]
                                  for g in fix.goal_results},
        replicas_on_dead_brokers_after=int(np.isin(final, dead).sum()),
        oversized_partitions=oversized(monitored, final, dead),
        host_seconds=seconds)
    if "--served" in sys.argv:
        served = served_references(sim, monitor)
        bodies = served.pop("bodies")
        if "--bodies" in sys.argv:
            Path(sys.argv[sys.argv.index("--bodies") + 1]).write_text(json.dumps(bodies))
        out.update(served)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
