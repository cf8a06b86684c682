"""The framework's main configuration.

Re-creates the reference's `KafkaCruiseControlConfig`
(cc/config/KafkaCruiseControlConfig.java, ~100 keys) with the same key names
and defaults for everything this framework supports, so an operator's
cruisecontrol.properties carries over. Goal class names accept both the
reference's Java class paths (mapped onto our goal registry by simple name) and
native `cruise_control_torch...` paths.

Waived reference keys (present there, deliberately absent here): the eight
Kafka-client plumbing keys the reference passes straight into its embedded
NetworkClient/consumers — bootstrap.servers, client.id, connections.max.idle.ms,
metadata.max.age.ms, receive.buffer.bytes, send.buffer.bytes,
reconnect.backoff.ms, request.timeout.ms (KafkaCruiseControlConfig.java:724-806).
Neither package has an in-process Kafka client: cluster I/O rides the agent
wire protocol (the JAX package's executor/tcp_driver.py, docs/CLUSTER_AGENT.md;
this package takes it in step 3b of ROADMAP.md Queue 1 item 7), whose
transport knobs live on the agent command line / driver constructor instead.
Every other reference key exists here under the identical name.

This is the JAX package's configuration key for key and default for default,
its `tpu.*` and optimizer keys included under their own names and with their
own documentation (which describes the JAX package's use of them), so that
one properties file configures both packages. Each class-name default names
this package's class. Two of them name detector classes this package has
not yet: `detector.notifier.NoopNotifier` resolves once the anomaly detector
is ported (step 4 of that item), and `detector.metric_anomaly.
NoopMetricAnomalyFinder` names a module the JAX package lacks as well, so
`get_configured_instance` raises ConfigException for it in both packages.
"""

from __future__ import annotations

from typing import Any, List, Mapping

from cruise_control_torch.config.configdef import (
    AbstractConfig,
    ConfigDef,
    Importance,
    Type,
    at_least,
    between,
    load_properties,
)

# Default goal stack, same order as the reference's default.goals
# (config/cruisecontrol.properties, cc/config/KafkaCruiseControlConfig.java:1287-1322).
DEFAULT_GOALS = [
    "RackAwareGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
    "ReplicaDistributionGoal",
    "PotentialNwOutGoal",
    "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
    "LeaderBytesInDistributionGoal",
]

HARD_GOALS = [
    "RackAwareGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
]

ANOMALY_DETECTION_GOALS = HARD_GOALS


def _config_def() -> ConfigDef:
    d = ConfigDef()
    # --- analyzer thresholds (reference defaults at KafkaCruiseControlConfig.java:1100-1250)
    for res in ("cpu", "disk", "network.inbound", "network.outbound"):
        d.define(f"{res}.balance.threshold", Type.DOUBLE, 1.10, at_least(1.0), Importance.HIGH,
                 f"Upper/lower margin around the average {res} utilization that counts as balanced.")
        d.define(f"{res}.capacity.threshold", Type.DOUBLE, 0.80, between(0.0, 1.0), Importance.HIGH,
                 f"Maximum fraction of {res} capacity usable before the capacity goal acts.")
        d.define(f"{res}.low.utilization.threshold", Type.DOUBLE, 0.0, between(0.0, 1.0), Importance.LOW,
                 f"Below this fraction of capacity a broker is considered idle for {res} balancing.")
    d.define("replica.count.balance.threshold", Type.DOUBLE, 1.10, at_least(1.0), Importance.MEDIUM,
             "Margin around the average replica count per broker that counts as balanced.")
    d.define("leader.replica.count.balance.threshold", Type.DOUBLE, 1.10, at_least(1.0), Importance.MEDIUM,
             "Margin around the average leader count per broker that counts as balanced.")
    d.define("topic.replica.count.balance.threshold", Type.DOUBLE, 3.00, at_least(1.0), Importance.LOW,
             "Margin around the average per-topic replica count per broker.")
    d.define("goal.violation.distribution.threshold.multiplier", Type.DOUBLE, 1.00, at_least(1.0), Importance.MEDIUM,
             "Relaxation multiplier applied to distribution-goal thresholds during self-healing.")
    d.define("max.replicas.per.broker", Type.LONG, 10000, at_least(0), Importance.MEDIUM,
             "Hard cap on replicas per broker (ReplicaCapacityGoal).")
    d.define("proposal.expiration.ms", Type.LONG, 900000, at_least(0), Importance.MEDIUM,
             "Precomputed proposals older than this are discarded and recomputed.")
    d.define("max.proposal.candidates", Type.INT, 10, at_least(1), Importance.LOW,
             "Precomputed proposal candidates kept per computation round.")
    d.define("num.proposal.precompute.threads", Type.INT, 1, at_least(1), Importance.LOW,
             "Worker threads for background proposal precomputation.")
    d.define("default.goals", Type.LIST, ",".join(DEFAULT_GOALS), None, Importance.HIGH,
             "Goals used (in priority order) when a request does not name goals.")
    d.define("goals", Type.LIST, ",".join(DEFAULT_GOALS), None, Importance.HIGH,
             "All goals this instance may use.")
    d.define("hard.goals", Type.LIST, ",".join(HARD_GOALS), None, Importance.HIGH,
             "Goals that must be satisfied by every proposal.")
    d.define("anomaly.detection.goals", Type.LIST, ",".join(ANOMALY_DETECTION_GOALS), None, Importance.MEDIUM,
             "Goals the goal-violation detector dry-runs.")
    # --- optimizer (TPU-native keys; no reference equivalent)
    d.define("optimizer.batch.actions.per.round", Type.INT, 16, at_least(1), Importance.MEDIUM,
             "Max non-conflicting actions applied per batched-greedy round (1 = faithful greedy).")
    d.define("optimizer.max.rounds.per.goal", Type.INT, 64, at_least(1), Importance.MEDIUM,
             "Upper bound on batched-greedy rounds per goal.")
    d.define("optimizer.candidate.replicas.per.broker", Type.INT, 8, at_least(1), Importance.MEDIUM,
             "Top-k replicas per overloaded broker considered as move sources each round.")
    d.define("optimizer.swap.broker.pairs", Type.INT, 8, at_least(1), Importance.MEDIUM,
             "Hot/cold broker pairs examined per swap round when moves stall.")
    d.define("optimizer.swap.candidate.replicas", Type.INT, 8, at_least(1), Importance.MEDIUM,
             "Candidate replicas per broker in the swap search grid.")
    d.define("optimizer.chunk.rounds", Type.INT, 32, at_least(0), Importance.MEDIUM,
             "Max optimizer rounds per device call (chunked goal machine); bounds device-call "
             "duration for remote-TPU transports. 0 = single fused-stack call.")
    d.define("optimizer.apply.waves", Type.INT, 8, at_least(1), Importance.MEDIUM,
             "Conflict-free apply waves per round (sequential depth of the shortlist apply).")
    d.define("optimizer.drain.source.brokers", Type.INT, 512, at_least(1), Importance.MEDIUM,
             "Top-V source brokers per drain/fill round (batched mode).")
    d.define("optimizer.drain.candidates.per.broker", Type.INT, 8, at_least(1), Importance.MEDIUM,
             "Drain candidates pulled from each source broker's sorted run per round.")
    d.define("optimizer.drain.destination.brokers", Type.INT, 64, at_least(1), Importance.MEDIUM,
             "Destination candidates per drained replica (goal-aware lists).")
    d.define("optimizer.bulk.count.waves", Type.INT, 16, at_least(0), Importance.MEDIUM,
             "Max conflict-free waves per bulk count-rebalance round: count-distribution goals "
             "drain their whole surplus/deficit grid per round instead of searching "
             "round-by-round. 0 disables the bulk planner.")
    d.define("optimizer.bulk.min.brokers", Type.INT, 32, at_least(0), Importance.LOW,
             "Bulk count planner size floor: clusters smaller than this keep the per-round "
             "engines only (they already nominate every broker per round at that scale).")
    d.define("optimizer.polish.rounds", Type.INT, 0, at_least(0), Importance.MEDIUM,
             "After the priority stack completes, re-run every goal up to this many rounds "
             "under the FULL merged acceptance tables (retries goals an earlier lexicographic "
             "pass stalled). 0 disables the polish pass.")
    d.define("optimizer.bucket.partitions", Type.BOOLEAN, True, None, Importance.MEDIUM,
             "Pad the partition/topic axes to coarse shape buckets so partition-count and "
             "topic-count churn reuses compiled programs instead of recompiling the stack.")
    d.define("optimizer.bucket.brokers", Type.BOOLEAN, True, None, Importance.MEDIUM,
             "Pad the broker/host/rack axes up the geometric bucket ladder so broker churn "
             "(add/remove, count drift) reuses the warm compiled program of the shared "
             "bucket. Padding brokers are invalid: never destinations, never in any goal "
             "window — bucketed runs are result-identical to the exact shape.")
    d.define("optimizer.bucket.ratio", Type.DOUBLE, 1.25, between(1.01, 2.0), Importance.LOW,
             "Geometric step of the broker bucket ladder (1.25 = quarter-octave rungs, "
             "worst-case 25% padding).")
    d.define("optimizer.bucket.floor", Type.INT, 64, at_least(1), Importance.LOW,
             "Broker counts at or below this stay exact (no padding); tiny clusters "
             "recompile per shape but pay zero padding overhead.")
    d.define("optimizer.incremental.enabled", Type.BOOLEAN, True, None, Importance.MEDIUM,
             "Arm the incremental rebalancing lane after each proposal: model drift is "
             "applied to the device-resident prepared context as in-place typed deltas "
             "and only the sensitivity-affected goal subset is re-solved "
             "(analyzer/incremental.py, docs/RESILIENCE.md).")
    d.define("optimizer.incremental.max.deltas", Type.INT, 64, at_least(1), Importance.MEDIUM,
             "Max typed deltas absorbed in one incremental re-proposal; larger drifts "
             "fall back to a full from-scratch solve (the delta batch is padded to this "
             "size, so it is also the scatter kernel's compiled batch shape).")
    d.define("optimizer.incremental.fallback.full", Type.BOOLEAN, True, None, Importance.MEDIUM,
             "When the incremental lane declines (shape bucket overflow, stale "
             "generation, sensitivity says all goals, ...), transparently run the full "
             "goal-violation rebalance instead of raising.")
    # --- monitor (windows/sampling; reference defaults in cruisecontrol.properties)
    d.define("partition.metrics.window.ms", Type.LONG, 300000, at_least(1), Importance.HIGH,
             "Width of one partition-metric aggregation window.")
    d.define("num.partition.metrics.windows", Type.INT, 1, at_least(1), Importance.HIGH,
             "Number of partition-metric windows retained.")
    d.define("min.samples.per.partition.metrics.window", Type.INT, 1, at_least(1), Importance.MEDIUM,
             "Minimum samples for a partition window to be valid without extrapolation.")
    d.define("broker.metrics.window.ms", Type.LONG, 300000, at_least(1), Importance.HIGH,
             "Width of one broker-metric aggregation window.")
    d.define("num.broker.metrics.windows", Type.INT, 20, at_least(1), Importance.HIGH,
             "Number of broker-metric windows retained.")
    d.define("min.samples.per.broker.metrics.window", Type.INT, 1, at_least(1), Importance.MEDIUM,
             "Minimum samples for a broker window to be valid without extrapolation.")
    d.define("metric.sampling.interval.ms", Type.LONG, 120000, at_least(1), Importance.MEDIUM,
             "Period of the sampling loop.")
    d.define("num.metric.fetchers", Type.INT, 1, at_least(1), Importance.LOW,
             "Parallel sampling fetchers; partitions are assigned across them.")
    d.define("metric.sampler.class", Type.CLASS,
             "cruise_control_torch.monitor.sampler.NoopSampler", None, Importance.MEDIUM,
             "MetricSampler implementation (pluggable).")
    d.define("sample.store.class", Type.CLASS,
             "cruise_control_torch.monitor.sample_store.NoopSampleStore", None, Importance.MEDIUM,
             "SampleStore implementation (pluggable); replayed on startup.")
    d.define("broker.capacity.config.resolver.class", Type.CLASS,
             "cruise_control_torch.monitor.metadata.BrokerCapacityConfigFileResolver", None, Importance.MEDIUM,
             "BrokerCapacityConfigResolver implementation.")
    d.define("capacity.config.file", Type.STRING, "config/capacity.json", None, Importance.MEDIUM,
             "JSON file of per-broker capacities for the file resolver.")
    d.define("min.valid.partition.ratio", Type.DOUBLE, 0.995, between(0.0, 1.0), Importance.MEDIUM,
             "Minimum monitored-partition fraction for a model to be considered complete.")
    d.define("leader.network.inbound.weight.for.cpu.util", Type.DOUBLE, 0.6, at_least(0.0), Importance.LOW,
             "Fixed-coefficient CPU attribution: weight of leader bytes-in (ModelUtils).")
    d.define("follower.network.inbound.weight.for.cpu.util", Type.DOUBLE, 0.3, at_least(0.0), Importance.LOW,
             "Fixed-coefficient CPU attribution: weight of follower bytes-in (ModelUtils).")
    d.define("leader.network.outbound.weight.for.cpu.util", Type.DOUBLE, 0.1, at_least(0.0), Importance.LOW,
             "Fixed-coefficient CPU attribution: weight of leader bytes-out (ModelUtils).")
    d.define("use.linear.regression.model", Type.BOOLEAN, False, None, Importance.LOW,
             "Use the trained linear-regression CPU model instead of fixed coefficients.")
    # --- executor (reference defaults in cruisecontrol.properties)
    d.define("num.concurrent.partition.movements.per.broker", Type.INT, 10, at_least(1), Importance.HIGH,
             "In-flight inter-broker replica moves allowed per broker.")
    d.define("num.concurrent.leader.movements", Type.INT, 1000, at_least(1), Importance.HIGH,
             "In-flight leadership moves allowed cluster-wide.")
    d.define("execution.progress.check.interval.ms", Type.LONG, 10000, at_least(1), Importance.MEDIUM,
             "Poll period for task completion during execution.")
    d.define("default.replica.movement.strategies", Type.LIST,
             "cruise_control_torch.executor.strategy.BaseReplicaMovementStrategy", None, Importance.LOW,
             "Strategy chain ordering replica movements.")
    d.define("removed.broker.history.retention.ms", Type.LONG, 43200000, at_least(0), Importance.LOW,
             "How long removed-broker history is kept.")
    d.define("demoted.broker.history.retention.ms", Type.LONG, 43200000, at_least(0), Importance.LOW,
             "How long demoted-broker history is kept.")
    # --- anomaly detection (reference defaults at KafkaCruiseControlConfig.java)
    d.define("anomaly.detection.interval.ms", Type.LONG, 300000, at_least(1), Importance.MEDIUM,
             "Period of the anomaly detectors.")
    d.define("anomaly.notifier.class", Type.CLASS,
             "cruise_control_torch.detector.notifier.NoopNotifier", None, Importance.MEDIUM,
             "AnomalyNotifier implementation.")
    d.define("metric.anomaly.finder.class", Type.CLASS,
             "cruise_control_torch.detector.metric_anomaly.NoopMetricAnomalyFinder", None, Importance.LOW,
             "MetricAnomalyFinder implementation.")
    d.define("metric.anomaly.percentile.upper.threshold", Type.DOUBLE, 90.0, between(0.0, 100.0), Importance.LOW,
             "Percentile above which a current metric is anomalous.")
    d.define("metric.anomaly.percentile.lower.threshold", Type.DOUBLE, 10.0, between(0.0, 100.0), Importance.LOW,
             "Percentile below which a current metric is anomalous.")
    d.define("self.healing.enabled", Type.BOOLEAN, False, None, Importance.HIGH,
             "Master switch for self-healing on detected anomalies.")
    d.define("broker.failure.alert.threshold.ms", Type.LONG, 900000, at_least(0), Importance.MEDIUM,
             "Grace period before a broker failure raises an alert.")
    d.define("broker.failure.self.healing.threshold.ms", Type.LONG, 1800000, at_least(0), Importance.MEDIUM,
             "Grace period before a broker failure triggers self-healing.")
    d.define("failed.brokers.file.path", Type.STRING, "failed_brokers.json", None, Importance.LOW,
             "Where failed-broker times are persisted across restarts.")
    # --- webserver / user tasks (reference defaults at KafkaCruiseControlConfig.java:861+)
    d.define("webserver.http.port", Type.INT, 9090, at_least(0), Importance.HIGH, "REST port.")
    d.define("webserver.http.address", Type.STRING, "127.0.0.1", None, Importance.HIGH, "REST bind address.")
    d.define("webserver.api.urlprefix", Type.STRING, "/kafkacruisecontrol/*", None, Importance.LOW, "API prefix.")
    d.define("webserver.http.cors.enabled", Type.BOOLEAN, False, None, Importance.LOW, "Enable CORS headers.")
    d.define("max.active.user.tasks", Type.INT, 5, at_least(1), Importance.MEDIUM,
             "Concurrent async user tasks allowed.")
    d.define("max.cached.completed.user.tasks", Type.INT, 25, at_least(0), Importance.LOW,
             "Completed user tasks kept for result retrieval.")
    d.define("completed.user.task.retention.time.ms", Type.LONG, 86400000, at_least(0), Importance.LOW,
             "How long completed user tasks are retained.")
    d.define("two.step.verification.enabled", Type.BOOLEAN, False, None, Importance.LOW,
             "Require review/approval of POST requests via the purgatory.")
    d.define("two.step.purgatory.max.requests", Type.INT, 25, at_least(1), Importance.LOW,
             "Max requests parked in the purgatory.")
    d.define("two.step.purgatory.retention.time.ms", Type.LONG, 1209600000, at_least(0), Importance.LOW,
             "Retention of reviewed requests in the purgatory.")
    # --- remaining reference keys (KafkaCruiseControlConfig.java), same names
    # and defaults so an operator's cruisecontrol.properties parses unchanged
    d.define("self.healing.goals", Type.LIST, "", None, Importance.MEDIUM,
             "Goals used for self-healing; empty = the anomaly-detection goals.")
    d.define("intra.broker.goals", Type.LIST, "", None, Importance.LOW,
             "Intra-broker (disk-to-disk) goals; empty = disabled.")
    d.define("topics.excluded.from.partition.movement", Type.STRING, "", None, Importance.MEDIUM,
             "Regex of topics whose replicas must never move.")
    d.define("replica.movement.strategies", Type.LIST,
             "cruise_control_torch.executor.strategy.PostponeUrpReplicaMovementStrategy,"
             "cruise_control_torch.executor.strategy.PrioritizeLargeReplicaMovementStrategy,"
             "cruise_control_torch.executor.strategy.PrioritizeSmallReplicaMovementStrategy,"
             "cruise_control_torch.executor.strategy.BaseReplicaMovementStrategy",
             None, Importance.LOW,
             "Replica-movement strategies available for chaining.")
    d.define("executor.notifier.class", Type.CLASS,
             "cruise_control_torch.executor.notifier.LoggingExecutorNotifier", None, Importance.LOW,
             "ExecutorNotifier implementation.")
    d.define("metric.sampler.partition.assignor.class", Type.CLASS,
             "cruise_control_torch.monitor.fetcher.DefaultMetricSamplerPartitionAssignor",
             None, Importance.LOW,
             "MetricSamplerPartitionAssignor implementation for the fetcher manager.")
    d.define("network.client.provider.class", Type.CLASS,
             "cruise_control_torch.monitor.metadata.MetadataClient", None, Importance.LOW,
             "Cluster-facing network client provider (host-side I/O).")
    d.define("max.allowed.extrapolations.per.partition", Type.INT, 5, at_least(0), Importance.LOW,
             "Partitions with more extrapolated windows than this are invalid.")
    d.define("max.allowed.extrapolations.per.broker", Type.INT, 5, at_least(0), Importance.LOW,
             "Brokers with more extrapolated windows than this are invalid.")
    d.define("linear.regression.model.cpu.util.bucket.size", Type.INT, 5, between(1, 100), Importance.LOW,
             "CPU-utilization bucket width (percent) for LR observation balancing.")
    d.define("anomaly.detection.allow.capacity.estimation", Type.BOOLEAN, True, None, Importance.LOW,
             "Allow estimated broker capacities during anomaly detection.")
    d.define("goal.violation.exclude.recently.demoted.brokers", Type.BOOLEAN, True, None, Importance.LOW,
             "Exclude recently demoted brokers from goal-violation leadership fixes.")
    d.define("goal.violation.exclude.recently.removed.brokers", Type.BOOLEAN, True, None, Importance.LOW,
             "Exclude recently removed brokers from goal-violation replica fixes.")
    d.define("broker.failure.exclude.recently.demoted.brokers", Type.BOOLEAN, True, None, Importance.LOW,
             "Exclude recently demoted brokers from broker-failure leadership fixes.")
    d.define("broker.failure.exclude.recently.removed.brokers", Type.BOOLEAN, True, None, Importance.LOW,
             "Exclude recently removed brokers from broker-failure replica fixes.")
    d.define("num.cached.recent.anomaly.states", Type.INT, 10, at_least(1), Importance.LOW,
             "Recent anomaly states kept per anomaly type for /state.")
    d.define("demotion.history.retention.time.ms", Type.LONG, 1209600000, at_least(0), Importance.LOW,
             "How long demotion history is kept (reference default 336h).")
    d.define("removal.history.retention.time.ms", Type.LONG, 1209600000, at_least(0), Importance.LOW,
             "How long removal history is kept (reference default 336h).")
    d.define("max.cached.completed.kafka.monitor.user.tasks", Type.INT, 25, at_least(0), Importance.LOW,
             "Completed monitor-type user tasks retained (per-type retention).")
    d.define("max.cached.completed.kafka.admin.user.tasks", Type.INT, 25, at_least(0), Importance.LOW,
             "Completed admin-type user tasks retained (per-type retention).")
    # per-type caches/retention for CC-endpoint tasks; negative = fall back
    # to the generic key (the reference defaults these to null with the same
    # fallback, KafkaCruiseControlConfig.java:967-1022)
    d.define("max.cached.completed.cruise.control.monitor.user.tasks", Type.INT, -1, None,
             Importance.LOW, "Completed CC-monitor-type user tasks retained; "
             "negative = max.cached.completed.user.tasks.")
    d.define("max.cached.completed.cruise.control.admin.user.tasks", Type.INT, -1, None,
             Importance.LOW, "Completed CC-admin-type user tasks retained; "
             "negative = max.cached.completed.user.tasks.")
    d.define("completed.cruise.control.monitor.user.task.retention.time.ms", Type.LONG, -1, None,
             Importance.LOW, "Retention of completed CC-monitor-type user tasks; "
             "negative = completed.user.task.retention.time.ms.")
    d.define("completed.cruise.control.admin.user.task.retention.time.ms", Type.LONG, -1, None,
             Importance.LOW, "Retention of completed CC-admin-type user tasks; "
             "negative = completed.user.task.retention.time.ms.")
    d.define("completed.kafka.monitor.user.task.retention.time.ms", Type.LONG, -1, None,
             Importance.LOW, "Retention of completed kafka-monitor-type user tasks; "
             "negative = completed.user.task.retention.time.ms.")
    d.define("completed.kafka.admin.user.task.retention.time.ms", Type.LONG, -1, None,
             Importance.LOW, "Retention of completed kafka-admin-type user tasks; "
             "negative = completed.user.task.retention.time.ms.")
    d.define("partition.metric.sample.aggregator.completeness.cache.size", Type.INT, 5,
             at_least(0), Importance.LOW,
             "Reference-parity key (KafkaCruiseControlConfig.java:940). The "
             "TPU aggregator recomputes completeness per call — one dense "
             "reduction over the ring buffers, cheaper than the reference's "
             "object walk it caches — so this key is accepted but unused.")
    d.define("broker.metric.sample.aggregator.completeness.cache.size", Type.INT, 5,
             at_least(0), Importance.LOW,
             "Reference-parity key (KafkaCruiseControlConfig.java:1049); "
             "accepted but unused, as the partition twin above.")
    d.define("linear.regression.model.min.num.cpu.util.buckets", Type.INT, 5, at_least(1),
             Importance.LOW,
             "Minimum full CPU-utilization buckets required before the linear "
             "regression model is considered trained (KafkaCruiseControlConfig.java:1121).")
    d.define("linear.regression.model.required.samples.per.bucket", Type.INT, 100, at_least(1),
             Importance.LOW,
             "Training samples required per CPU-utilization bucket "
             "(KafkaCruiseControlConfig.java:1126).")
    # static web-UI serving (KafkaCruiseControlMain.java:75-111)
    d.define("webserver.ui.diskpath", Type.STRING, "", None, Importance.LOW,
             "Directory of static web-UI files to serve; empty = disabled.")
    d.define("webserver.ui.urlprefix", Type.STRING, "/*", None, Importance.LOW,
             "URL prefix the static web-UI is served under.")
    d.define("webserver.http.cors.origin", Type.STRING, "*", None, Importance.LOW,
             "CORS Access-Control-Allow-Origin value.")
    d.define("webserver.http.cors.allowmethods", Type.STRING, "OPTIONS, GET, POST", None, Importance.LOW,
             "CORS Access-Control-Allow-Methods value.")
    d.define("webserver.http.cors.exposeheaders", Type.STRING, "User-Task-ID", None, Importance.LOW,
             "CORS Access-Control-Expose-Headers value.")
    d.define("failed.brokers.zk.path", Type.STRING, "/CruiseControlBrokerList", None, Importance.LOW,
             "Reference-compat alias of failed.brokers.file.path for ZK deployments.")
    d.define("zookeeper.connect", Type.STRING, "", None, Importance.LOW,
             "Reference-compat: ZK quorum of the managed cluster (unused by the "
             "simulator driver; a ZK-backed ClusterDriver reads it).")
    d.define("zookeeper.security.enabled", Type.BOOLEAN, False, None, Importance.LOW,
             "Reference-compat: secure ZK for the managed cluster.")
    # --- TPU execution
    d.define("tpu.mesh.axis.name", Type.STRING, "partitions", None, Importance.LOW,
             "Mesh axis name candidate/partition arrays are sharded over "
             "(parallel/sharding.make_mesh_from_config; the shard_map kernels "
             "read it back off the mesh, docs/SHARDING.md).")
    d.define("tpu.mesh.devices", Type.INT, 0, at_least(0), Importance.LOW,
             "Devices in the partition-axis mesh: 0 = auto (all visible "
             "devices, mesh only when more than one), 1 = sharding disabled, "
             "N = exactly the first N visible devices (error when fewer).")
    # cclint: disable=reg-config-key-reachable -- reserved knob: donation is unconditional in the jit factories (optimizer.py donate_argnums); making it configurable changes program identity and waits for the ROADMAP-1 on-device round fusion, whose donation set is certified per commit by trace-donation-integrity and whose while/scan carries by trace-carry-stability (lint/entrypoints.py: fused-stack-step / chunked-goal-machine)
    d.define("tpu.donate.model.buffers", Type.BOOLEAN, True, None, Importance.LOW,
             "Donate model buffers between optimizer rounds to avoid copies.")
    # --- resilience (TPU-native keys; docs/RESILIENCE.md)
    d.define("executor.task.deadline.s", Type.DOUBLE, 0.0, at_least(0.0), Importance.MEDIUM,
             "Per-task wall-clock deadline during execution: a task IN_PROGRESS longer "
             "than this is aborted (ABORTING -> ABORTED) and its broker slots released, "
             "while the rest of the batch continues. 0 disables (the poll cap still "
             "bounds the phase).")
    d.define("executor.retry.attempts", Type.INT, 4, at_least(1), Importance.MEDIUM,
             "Attempts per cluster-agent op (reconnect-on-failure between attempts). "
             "All five protocol ops are retry-safe: finished/ongoing/ping are reads, "
             "reassign/leader are executionId-idempotent.")
    d.define("executor.retry.backoff.s", Type.DOUBLE, 0.05, at_least(0.0), Importance.LOW,
             "Base backoff before the first retry; doubles per attempt.")
    d.define("executor.retry.max.backoff.s", Type.DOUBLE, 2.0, at_least(0.0), Importance.LOW,
             "Backoff ceiling for the exponential ladder.")
    d.define("selfhealing.breaker.threshold", Type.INT, 3, at_least(1), Importance.MEDIUM,
             "Consecutive failed self-healing fixes of one anomaly type before that "
             "type's circuit breaker opens and fixes degrade to delayed CHECKs.")
    d.define("selfhealing.breaker.cooldown.s", Type.DOUBLE, 300.0, at_least(0.0), Importance.MEDIUM,
             "Seconds an open self-healing breaker waits before admitting one "
             "half-open probe fix (success closes it, failure re-opens).")
    d.define("executor.proposal.revalidate", Type.BOOLEAN, True, None, Importance.MEDIUM,
             "Revalidate generation-stamped proposals against fresh metadata at "
             "admission and before every dispatch batch; stale proposals are trimmed "
             "with per-proposal reason codes (DEST_DEAD, REPLICA_MOVED, TOPIC_GONE, ...) "
             "into the execution summary instead of being dispatched or raising.")
    d.define("executor.proposal.max.generation.skew", Type.INT, 8, at_least(0), Importance.MEDIUM,
             "Abort the whole proposal batch (through the never-raise contract) and "
             "notify the anomaly detector to recompute when the monitor generation "
             "has moved more than this past the batch's model-build stamp. "
             "0 disables the abort (per-proposal trimming still applies).")
    # --- observability (TPU-native keys; docs/OBSERVABILITY.md)
    d.define("observability.trace.ring.size", Type.INT, 4096, at_least(16), Importance.LOW,
             "Completed tracer spans retained in memory (the /trace window); "
             "oldest spans drop first.")
    d.define("observability.trace.jsonl.path", Type.STRING, "", None, Importance.LOW,
             "Append every completed tracer span as one JSON line to this file "
             "(durable traces); empty = disabled.")
    d.define("observability.profile.dir", Type.STRING, "", None, Importance.LOW,
             "Arm a one-shot JAX profiler capture: the first proposal computation "
             "after startup writes an xplane trace here (parse with "
             "scripts/parse_xplane.py); empty = disabled.")
    d.define("observability.history.interval.s", Type.DOUBLE, 0.0, at_least(0.0), Importance.LOW,
             "Cadence of the background sensor time-series sampler (GET /timeseries). "
             "0 (the default) disables the sampler thread; snapshots still happen at "
             "proposal/execution boundaries and on /timeseries scrapes.")
    d.define("observability.history.ring.size", Type.INT, 512, at_least(16), Importance.LOW,
             "Sensor-registry snapshots retained in the time-series ring; oldest "
             "points drop first.")
    d.define("observability.history.jsonl.path", Type.STRING, "", None, Importance.LOW,
             "Append every history snapshot as one JSON line to this file (durable "
             "time series, next to the trace JSONL sink); empty = disabled.")
    d.define("telemetry.enabled", Type.BOOLEAN, True, None, Importance.LOW,
             "Collect device telemetry (per-program XLA cost analysis, device memory "
             "watermarks, host-device transfer meters) into the sensor registry and "
             "GET /perf; disable to shave the (already <2%) collection overhead.")
    d.define("optimizer.provenance.ledger", Type.BOOLEAN, True, None, Importance.LOW,
             "Collect the decision-provenance MoveLedger: compiled programs snapshot "
             "the assignment + attribution tags once per goal phase, and every run's "
             "per-move goal/engine/round attribution becomes queryable via "
             "GET /explain and scripts/diff_runs.py. Disabling removes the snapshot "
             "buffers from the compiled programs (recompile on toggle); proposals "
             "are byte-identical either way.")
    d.define("observability.ledger.runs", Type.INT, 8, at_least(1), Importance.LOW,
             "Recorded optimization runs retained by the provenance MoveLedger "
             "(GET /explain's query window); oldest runs evict first.")
    return d


_DEF = _config_def()


def _simple_goal_name(name: str) -> str:
    """Accept reference Java class paths by mapping to their simple name."""
    return name.rsplit(".", 1)[-1]


class CruiseControlConfig(AbstractConfig):
    def __init__(self, props: Mapping[str, Any] | None = None):
        super().__init__(_DEF, dict(props or {}))

    @classmethod
    def from_properties_file(cls, path: str) -> "CruiseControlConfig":
        return cls(load_properties(path))

    def goal_names(self, key: str = "default.goals") -> List[str]:
        return [_simple_goal_name(g) for g in self.get_list(key)]
