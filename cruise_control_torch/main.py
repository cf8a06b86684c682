"""Service entry point.

The JAX package's main.py (the analog of KafkaCruiseControlMain,
cc/KafkaCruiseControlMain.java:25): load the configuration, wire monitor +
analyzer + executor + detector behind the facade, start the background loops
(sampling, proposal precompute, anomaly detection) and serve the REST API.
With no Kafka in reach, the service runs against the in-process simulator (a
seeded synthetic cluster), so the whole loop runs end to end:

    python -m cruise_control_torch.main --port 9090 --simulate-brokers 12

The solves run on the card (`--device cuda`, the default). `main` probes it
in a subprocess before anything touches it, and a card that does not answer
stops the service with an error that names it: there is no CPU fallback.
`--device cpu` runs every solve on the CPU through the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import sys


def build_simulated_service(
    num_brokers: int = 12,
    num_racks: int = 4,
    num_topics: int = 20,
    seed: int = 42,
    window_s: float = 5.0,
    two_step_verification: bool = False,
    webui_dir: str = None,
    webui_prefix: str = "/",
    config_path: str = None,
    device: str = "cuda",
):
    """Wire the full stack over a simulated cluster; returns (app, parts).

    `config_path`: optional cruisecontrol.properties — the analyzer keys
    (balancing thresholds, `optimizer.*` including `optimizer.polish.rounds`,
    the bulk count-planner knobs, and the `optimizer.incremental.*` lane)
    map onto the goal engine through
    BalancingConstraint.from_config / OptimizerSettings.from_config, the
    `observability.*` keys configure the span tracer (ring size, JSONL sink),
    arm the one-shot profiler capture, and shape the sensor time-series
    store (`observability.history.*` — ring size, JSONL sink, sampler
    cadence) while `telemetry.enabled` gates the device-telemetry collector,
    and the resilience keys (`executor.task.deadline.s`, `executor.retry.*`,
    `executor.proposal.revalidate`, `executor.proposal.max.generation.skew`,
    `selfhealing.breaker.*`) shape the executor deadline/retry/drift-safety
    behavior and the self-healing circuit breakers. `tpu.mesh.devices` and
    `tpu.mesh.axis.name` build the partition-axis mesh the optimizer solves
    on (parallel/sharding.make_mesh_from_config: a mesh larger than the
    visible cards is refused, as the JAX package refuses it). `device` is
    where every solve runs: on a mesh, the mesh's first card."""
    from cruise_control_torch.analyzer.incremental import IncrementalConfig
    from cruise_control_torch.analyzer.optimizer import GoalOptimizer, OptimizerSettings
    from cruise_control_torch.async_ops import AsyncCruiseControl
    from cruise_control_torch.detector import AnomalyDetector, SelfHealingNotifier
    from cruise_control_torch.executor import Executor, ExecutorConfig, SimulatorClusterDriver
    from cruise_control_torch.facade import CruiseControl, FacadeConfig
    from cruise_control_torch.models.generators import ClusterProperty, random_cluster
    from cruise_control_torch.monitor.completeness import ModelCompletenessRequirements
    from cruise_control_torch.monitor.load_monitor import LoadMonitor, LoadMonitorConfig
    from cruise_control_torch.monitor.metadata import MetadataClient
    from cruise_control_torch.monitor.sampler import TransportMetricSampler
    from cruise_control_torch.monitor.task_runner import LoadMonitorTaskRunner
    from cruise_control_torch.reporter import MetricsReporter, MetricsReporterConfig
    from cruise_control_torch.reporter.transport import InMemoryTransport
    from cruise_control_torch.servlet.server import CruiseControlApp
    from cruise_control_torch.testing.simulator import SimulatedCluster

    truth = random_cluster(
        seed,
        ClusterProperty(
            num_racks=num_racks, num_brokers=num_brokers, num_topics=num_topics,
            replication_factor=min(3, num_racks),
        ),
    )
    sim = SimulatedCluster(truth)
    transport = InMemoryTransport()
    reporters = [
        MetricsReporter(
            i, sim.metric_source(i), transport,
            MetricsReporterConfig(reporting_interval_s=window_s / 3),
        )
        for i in range(num_brokers)
    ]
    monitor = LoadMonitor(
        MetadataClient(sim.fetch_topology, ttl_s=window_s),
        TransportMetricSampler(transport),
        config=LoadMonitorConfig(
            window_ms=int(window_s * 1000), num_windows=5, min_samples_per_window=1,
            sampling_interval_s=window_s / 2,
        ),
    )
    runner = LoadMonitorTaskRunner(monitor)

    optimizer = GoalOptimizer(settings=OptimizerSettings(), device=device)
    executor_config = ExecutorConfig()
    notifier = SelfHealingNotifier()
    executor_notifier = None
    incremental_config = IncrementalConfig()
    if config_path:
        from cruise_control_torch.config.balancing import BalancingConstraint
        from cruise_control_torch.config.configdef import load_properties
        from cruise_control_torch.config.cruise_config import CruiseControlConfig

        cfg = CruiseControlConfig(load_properties(config_path))
        # tpu.mesh.* -> the partition-axis mesh (None on one card or with
        # tpu.mesh.devices=1); the optimizer runs the greedy grid's shortlist
        # shard by shard on it (parallel/spmd.py)
        from cruise_control_torch.parallel.sharding import make_mesh_from_config

        mesh = make_mesh_from_config(cfg)
        optimizer = GoalOptimizer(
            constraint=BalancingConstraint.from_config(cfg),
            settings=OptimizerSettings.from_config(cfg),
            device=device,
            mesh=mesh,
        )
        # resilience keys: executor deadlines/concurrency and the
        # self-healing breaker ladder. The simulator driver needs no retry
        # policy; a TcpClusterDriver deployment builds its RetryPolicy from
        # the same config (RetryPolicy.from_config).
        executor_config = ExecutorConfig.from_config(cfg)
        # executor lifecycle events flow to the configured sink
        # (`executor.notifier.class`; default: the operation audit log)
        from cruise_control_torch.executor.notifier import ExecutorNotifier

        executor_notifier = cfg.get_configured_instance(
            "executor.notifier.class", ExecutorNotifier
        )
        notifier = SelfHealingNotifier(
            breaker_threshold=cfg.get_int("selfhealing.breaker.threshold"),
            breaker_cooldown_s=cfg.get_double("selfhealing.breaker.cooldown.s"),
        )
        from cruise_control_torch.common import tracing
        from cruise_control_torch.common.history import HISTORY
        from cruise_control_torch.common.telemetry import TELEMETRY

        tracing.TRACER.configure(
            ring_size=cfg.get_int("observability.trace.ring.size"),
            jsonl_path=cfg.get_string("observability.trace.jsonl.path") or None,
        )
        tracing.set_profile_dir(cfg.get_string("observability.profile.dir") or None)
        # perf observatory: the sensor time-series store (GET /timeseries) and
        # the device-telemetry collector (GET /perf)
        HISTORY.configure(
            ring_size=cfg.get_int("observability.history.ring.size"),
            jsonl_path=cfg.get_string("observability.history.jsonl.path"),
            interval_s=cfg.get_double("observability.history.interval.s"),
        )
        TELEMETRY.configure(enabled=cfg.get_boolean("telemetry.enabled"))
        # decision provenance: how many recorded runs GET /explain can query
        # (the ledger itself is the optimizer.provenance.ledger key above,
        # wired through OptimizerSettings.from_config)
        from cruise_control_torch.analyzer.provenance import LEDGER

        LEDGER.configure(max_runs=cfg.get_int("observability.ledger.runs"))
        # incremental rebalancing lane (optimizer.incremental.*): in-place
        # model deltas + goal-scoped re-solve
        incremental_config = IncrementalConfig.from_config(cfg)
    executor = Executor(
        SimulatorClusterDriver(sim, latency_polls=2),
        config=executor_config, load_monitor=monitor,
        notifier=executor_notifier,
    )
    facade = CruiseControl(
        monitor, executor, optimizer=optimizer,
        config=FacadeConfig(
            default_requirements=ModelCompletenessRequirements(1, 0.5, False),
            incremental=incremental_config,
        ),
    )
    acc = AsyncCruiseControl(facade)
    detector = AnomalyDetector(facade, notifier=notifier)
    app = CruiseControlApp(
        acc, anomaly_detector=detector, two_step_verification=two_step_verification,
        webui_dir=webui_dir, webui_prefix=webui_prefix,
    )
    parts = {
        "sim": sim, "reporters": reporters, "monitor": monitor, "runner": runner,
        "executor": executor, "facade": facade, "acc": acc, "detector": detector,
    }
    return app, parts


def start_background(parts, precompute_interval_s: float = 30.0,
                     detection_interval_s: float = 60.0) -> None:
    for r in parts["reporters"]:
        r.start()
    parts["runner"].start()
    parts["acc"].start_proposal_precompute(interval_s=precompute_interval_s)
    parts["detector"]._config = type(parts["detector"]._config)(
        detection_interval_s=detection_interval_s
    )
    parts["detector"].start_detection()
    # history sampler: a no-op unless observability.history.interval.s > 0
    from cruise_control_torch.common.history import HISTORY

    HISTORY.start()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="cruise-control-torch")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9090)
    parser.add_argument("--simulate-brokers", type=int, default=12)
    parser.add_argument("--simulate-topics", type=int, default=20)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--config", default=None, metavar="PATH",
                        help="cruisecontrol.properties; analyzer keys (balancing "
                             "thresholds, optimizer.*) map onto the goal engine")
    parser.add_argument("--device", default="cuda",
                        help="where the solves run: the card (cuda, the default, or "
                             "cuda:<n>) or cpu; a card that does not answer is an error")
    parser.add_argument("--two-step-verification", action="store_true")
    parser.add_argument("--access-log", default=None, metavar="PATH",
                        help="append HTTP requests to PATH in NCSA combined format")
    parser.add_argument("--operation-log", default=None, metavar="PATH",
                        help="append the operation audit trail (executions, anomaly "
                             "decisions, self-healing fixes) to PATH")
    parser.add_argument("--webui-dir", default=None, metavar="DIR",
                        help="serve static web-UI files from DIR "
                             "(webserver.ui.diskpath, KafkaCruiseControlMain.java:75)")
    parser.add_argument("--webui-prefix", default="/", metavar="PREFIX",
                        help="URL prefix for the static web-UI (webserver.ui.urlprefix)")
    args = parser.parse_args(argv)

    # probe the card before anything touches it: a dead, missing or hanging
    # card stops the service here, naming it (platform_probe)
    from cruise_control_torch.platform_probe import DeviceUnavailableError, ensure_live_backend

    try:
        ensure_live_backend(device=args.device)
    except (DeviceUnavailableError, ValueError) as e:
        print(f"cruise-control-torch: {e}", file=sys.stderr)
        return 1

    from cruise_control_torch.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    from cruise_control_torch.servlet.server import run_server

    try:
        app, parts = build_simulated_service(
            num_brokers=args.simulate_brokers, num_topics=args.simulate_topics,
            seed=args.seed, two_step_verification=args.two_step_verification,
            webui_dir=args.webui_dir, webui_prefix=args.webui_prefix,
            config_path=args.config, device=args.device,
        )
    except ValueError as e:
        print(f"cruise-control-torch: {e}", file=sys.stderr)
        return 1
    if args.operation_log:
        import logging

        from cruise_control_torch.common.oplog import OPERATION_LOG

        handler = logging.FileHandler(args.operation_log)
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        OPERATION_LOG.addHandler(handler)
        OPERATION_LOG.setLevel(logging.INFO)
        # audit lines go to the file only — with root logging configured,
        # propagation would duplicate every line to the root handlers
        OPERATION_LOG.propagate = False
    start_background(parts)
    print(f"cruise-control-torch serving on http://{args.host}:{args.port}"
          "/kafkacruisecontrol/state", flush=True)
    try:
        run_server(app, host=args.host, port=args.port, access_log_path=args.access_log)
    finally:
        parts["acc"].shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
