"""LoadMonitor: windows -> FlatClusterModel.

Analog of cc/monitor/LoadMonitor.java:68 — owns the partition and broker
aggregators, samples through the pluggable sampler, persists through the
sample store, and on demand assembles the flattened cluster model
(clusterModel :422-487: topology from metadata + capacities from the resolver
+ per-partition window loads). Model generation is guarded by a fairness
semaphore (`acquire_for_model_generation` :357) and the result summarizes into
BrokerStats for the /load endpoint.

The window->expected-utilization reduction (Load.expectedUtilizationFor) is
where windows collapse to the part_load matrix: CPU/NW are window-averaged,
DISK takes the latest window — computed as one numpy pass over the
aggregation result.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import numpy as np

from cruise_control_torch.common.resources import NUM_PART_METRICS, BrokerState, PartMetric
from cruise_control_torch.models.flat_model import ClusterMetadata, from_numpy
from cruise_control_torch.models.model_utils import follower_cpu_util_from_leader_load
from cruise_control_torch.monitor.aggregator import (
    AggregationOptions,
    Extrapolation,
    WindowedAggregator,
)
from cruise_control_torch.monitor.completeness import (
    ModelCompletenessRequirements,
    NotEnoughValidPartitionsError,
    NotEnoughValidWindowsError,
)
from cruise_control_torch.monitor.metadata import (
    BrokerCapacityConfigResolver,
    MetadataClient,
    StaticCapacityResolver,
)
from cruise_control_torch.monitor.metricdef import (
    AGGREGATION_OF,
    NUM_BROKER_METRICS,
    NUM_COMMON_METRICS,
    COMMON_METRIC_DEFS,
    KafkaMetricDef,
)
from cruise_control_torch.monitor.sample_store import NoopSampleStore, SampleStore
from cruise_control_torch.monitor.sampler import MetricSampler, Samples
from cruise_control_torch.monitor.samples import as_batch


@dataclasses.dataclass(frozen=True)
class LoadMonitorConfig:
    """Window knobs; key names mirror num.partition.metrics.windows etc."""

    window_ms: int = 60_000
    num_windows: int = 5
    min_samples_per_window: int = 3
    num_broker_windows: int = 20
    sampling_interval_s: float = 10.0


class LoadMonitorState:
    NOT_STARTED = "NOT_STARTED"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    SAMPLING = "SAMPLING"
    BOOTSTRAPPING = "BOOTSTRAPPING"
    TRAINING = "TRAINING"
    LOADING = "LOADING"


class IllegalMonitorStateError(RuntimeError):
    """An exclusive mode (bootstrap/training) was requested while another is
    in progress — the reference REJECTS the request rather than queueing it
    (LoadMonitorTaskRunner.bootstrap :127-177 throws IllegalStateException
    when the state machine is not in RUNNING)."""


class LoadMonitor:
    def __init__(
        self,
        metadata_client: MetadataClient,
        sampler: MetricSampler,
        sample_store: Optional[SampleStore] = None,
        capacity_resolver: Optional[BrokerCapacityConfigResolver] = None,
        config: LoadMonitorConfig = LoadMonitorConfig(),
        clock: Callable[[], float] = time.time,
    ):
        self._metadata = metadata_client
        self._sampler = sampler
        self._store = sample_store or NoopSampleStore()
        # bound the store to a multiple of the aggregation horizon: samples
        # past the horizon can't contribute to windows, but train_range /
        # bootstrap_range replay deeper history for the LR CPU model and
        # backfills, so keep several horizons (KafkaSampleStore's topic
        # retention is likewise operator-sized above the window horizon)
        self._store.configure_retention(8 * config.window_ms * config.num_windows)
        self._capacity = capacity_resolver or StaticCapacityResolver()
        self._config = config
        self._clock = clock
        self._state = LoadMonitorState.NOT_STARTED
        self._sampling_paused = False
        self._pause_reason: Optional[str] = None
        self._model_semaphore = threading.Semaphore(1)
        self._lock = threading.RLock()
        #: guards exclusive modes (one bootstrap/training at a time); entry
        #: is non-blocking — a concurrent request is REJECTED with
        #: IllegalMonitorStateError, matching the reference's behavior
        self._task_lock = threading.Lock()
        #: /state reporting of the active exclusive mode + progress
        #: (the reference surfaces bootstrap progress % via
        #: LoadMonitorTaskRunner's state)
        self._active_task: Optional[Dict] = None
        self._last_sample_ms = 0
        # sensor counters (cluster-model-creation-timer analog)
        self.sensors: Dict[str, float] = {"model_creations": 0, "model_creation_time_s": 0.0}
        #: trainable CPU-estimation model fed by train_range
        #: (cc/model/LinearRegressionModelParameters.java:26 analog)
        from cruise_control_torch.models.model_utils import LinearRegressionModelParameters

        self.lr_params = LinearRegressionModelParameters()

        topo = metadata_client.refresh_metadata()
        common_fns = [AGGREGATION_OF[d] for d in COMMON_METRIC_DEFS]
        broker_fns = [AGGREGATION_OF[d] for d in KafkaMetricDef]
        self._partition_agg = WindowedAggregator(
            num_entities=topo.num_partitions,
            num_metrics=NUM_COMMON_METRICS,
            aggregation_functions=common_fns,
            window_ms=config.window_ms,
            num_windows=config.num_windows,
            min_samples_per_window=config.min_samples_per_window,
            entity_group=np.asarray(topo.topic_id, dtype=np.int64),
        )
        self._broker_agg = WindowedAggregator(
            num_entities=topo.num_brokers,
            num_metrics=NUM_BROKER_METRICS,
            aggregation_functions=broker_fns,
            window_ms=config.window_ms,
            num_windows=config.num_broker_windows,
            min_samples_per_window=1,
        )

    # -- lifecycle / state -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def start_up(self) -> None:
        """Replay the sample store (SampleLoadingTask analog), then run."""
        with self._lock:
            self._state = LoadMonitorState.LOADING
        part, brok = self._store.load_samples()
        if part or brok:
            self._add_samples(Samples(part, brok), persist=False)
        with self._lock:
            self._state = LoadMonitorState.RUNNING

    def pause_metric_sampling(self, reason: str = "") -> None:
        with self._lock:
            self._sampling_paused = True
            self._pause_reason = reason
            self._state = LoadMonitorState.PAUSED

    def resume_metric_sampling(self) -> None:
        with self._lock:
            self._sampling_paused = False
            self._pause_reason = None
            self._state = LoadMonitorState.RUNNING

    @property
    def sampling_paused(self) -> bool:
        with self._lock:
            return self._sampling_paused

    # -- sampling --------------------------------------------------------------

    def sample_once(self) -> int:
        """One sampling round (SamplingTask analog); returns samples ingested."""
        with self._lock:
            if self._sampling_paused:
                return 0
            self._state = LoadMonitorState.SAMPLING
        try:
            topo = self._metadata.refresh_metadata()
            self._ensure_universe(topo)
            now_ms = int(self._clock() * 1000)
            start_ms = self._last_sample_ms
            samples = self._sampler.get_samples(topo, start_ms, now_ms)
            self._last_sample_ms = now_ms
            return self._add_samples(samples, persist=True)
        finally:
            with self._lock:
                if not self._sampling_paused:
                    self._state = LoadMonitorState.RUNNING

    def _restore_state(self) -> None:
        """Leave an exclusive mode without clobbering an operator pause."""
        with self._lock:
            self._state = (
                LoadMonitorState.PAUSED
                if self._sampling_paused
                else LoadMonitorState.RUNNING
            )

    @contextmanager
    def _exclusive_mode(self, mode: str, description: str = ""):
        """Enter an exclusive mode (BOOTSTRAPPING/TRAINING) or REJECT.

        The reference refuses to start a bootstrap/training while another
        exclusive task is in progress (LoadMonitorTaskRunner.bootstrap
        :127-177); this non-blocking guard is the single authoritative gate
        for every entry point (REST and task runner both land here)."""
        if not self._task_lock.acquire(blocking=False):
            active = (self._active_task or {}).get("mode", "unknown")
            raise IllegalMonitorStateError(
                f"cannot start {mode}: {active} is in progress"
            )
        try:
            with self._lock:
                self._state = mode
                self._active_task = {
                    "mode": mode, "progress": 0.0, "description": description,
                }
            yield
        finally:
            with self._lock:
                self._active_task = None
            self._restore_state()
            self._task_lock.release()

    def _set_task_progress(self, fraction: float) -> None:
        with self._lock:
            if self._active_task is not None:
                self._active_task["progress"] = round(min(1.0, max(0.0, fraction)), 4)

    @property
    def active_task(self) -> Optional[Dict]:
        """{'mode', 'progress', 'description'} of the running exclusive task
        (None when idle) — surfaced through /state."""
        with self._lock:
            return dict(self._active_task) if self._active_task else None

    def bootstrap(self, samples: Samples) -> int:
        """Backfill historic samples (LoadMonitorTaskRunner.bootstrap :127)."""
        with self._exclusive_mode(
            LoadMonitorState.BOOTSTRAPPING,
            f"{len(samples.partition_samples)}+{len(samples.broker_samples)} samples",
        ):
            topo = self._metadata.refresh_metadata()
            self._ensure_universe(topo)
            # ingest in slices so /state reports bootstrap progress
            part = list(samples.partition_samples)
            brok = list(samples.broker_samples)
            total = max(1, len(part) + len(brok))
            step = max(1, total // 10)
            added = 0
            done = 0
            for lo in range(0, len(part), step):
                added += self._add_samples(
                    Samples(part[lo:lo + step], []), persist=False
                )
                done += len(part[lo:lo + step])
                self._set_task_progress(done / total)
            for lo in range(0, len(brok), step):
                added += self._add_samples(
                    Samples([], brok[lo:lo + step]), persist=False
                )
                done += len(brok[lo:lo + step])
                self._set_task_progress(done / total)
            return added

    def bootstrap_range(self, start_ms: int, end_ms: Optional[int] = None) -> int:
        """Time-range bootstrap (BootstrapTask :21, the RANGE/SINCE modes of
        LoadMonitorTaskRunner.bootstrap :127-177): replay the sample store's
        history inside [start_ms, end_ms) into the window aggregators. The
        store is this deployment's durable history — the analog of seeking a
        consumer back through the metrics topic."""
        part, brok = self._store.load_samples()
        hi = end_ms if end_ms is not None else int(self._clock() * 1000)
        picked = Samples(
            [s for s in part if start_ms <= s.time_ms < hi],
            [s for s in brok if start_ms <= s.time_ms < hi],
        )
        return self.bootstrap(picked)

    def _lr_observe(self, metrics) -> bool:
        """Feed one broker-metric vector into the LR model; False if skipped."""
        from cruise_control_torch.monitor.metricdef import KafkaMetricDef

        cpu = float(metrics[KafkaMetricDef.CPU_USAGE])
        if cpu <= 0:
            return False
        self.lr_params.add_observation(
            cpu / 100.0,
            float(metrics[KafkaMetricDef.LEADER_BYTES_IN]),
            float(metrics[KafkaMetricDef.LEADER_BYTES_OUT]),
            float(metrics[KafkaMetricDef.REPLICATION_BYTES_IN_RATE]),
        )
        return True

    def train_range(self, start_ms: int, end_ms: Optional[int] = None) -> Dict:
        """Training mode (LoadMonitorTaskRunner.train :205 + TrainingTask/
        TrainingFetcher): feed broker samples from the range into the
        linear-regression CPU model (ModelParameters analog). Returns the fit
        summary; coefficients stay on `self.lr_params` for the estimator."""
        with self._exclusive_mode(
            LoadMonitorState.TRAINING, f"range [{start_ms}, {end_ms})"
        ):
            _, brok = self._store.load_samples()
            hi = end_ms if end_ms is not None else int(self._clock() * 1000)
            in_range = [s for s in brok if start_ms <= s.time_ms < hi]
            n = 0
            for i, s in enumerate(in_range):
                n += self._lr_observe(s.metrics)
                if i % 64 == 0:
                    self._set_task_progress(i / max(1, len(in_range)))
            if n == 0:
                # no durable history in range (e.g. Noop store): observe
                # the in-memory broker windows instead — the recent
                # history the TrainingFetcher would re-sample.
                try:
                    vals = self._broker_agg.aggregate().values  # [B, W, M]
                except ValueError:
                    vals = None
                if vals is not None:
                    n = sum(
                        self._lr_observe(vals[b, w])
                        for b in range(vals.shape[0])
                        for w in range(vals.shape[1])
                    )
            self._set_task_progress(1.0)
            coef = self.lr_params.train()
            return {
                "observations_added": int(n),
                "total_observations": self.lr_params.num_observations,
                "trained": coef is not None,
                "coefficients": None if coef is None else [float(c) for c in coef],
            }

    def _ensure_universe(self, topo) -> None:
        if topo.num_partitions > self._partition_agg.num_entities:
            self._partition_agg.resize(
                topo.num_partitions, np.asarray(topo.topic_id, dtype=np.int64)
            )
        if topo.num_brokers > self._broker_agg.num_entities:
            self._broker_agg.resize(topo.num_brokers)

    def _add_samples(self, samples: Samples, persist: bool) -> int:
        n = 0
        part = as_batch(samples.partition_samples, "partition")
        brok = as_batch(samples.broker_samples, "broker")
        if len(part):
            n += self._partition_agg.add_samples(part.ids, part.times, part.metrics)
        if len(brok):
            n += self._broker_agg.add_samples(brok.ids, brok.times, brok.metrics)
        if persist and (len(part) or len(brok)):
            self._store.store_samples(part, brok)
        return n

    # -- completeness ----------------------------------------------------------

    def meet_completeness_requirements(self, req: ModelCompletenessRequirements) -> bool:
        """LoadMonitor.meetCompletenessRequirements (:539)."""
        options = AggregationOptions(
            min_valid_entity_ratio=req.min_monitored_partitions_percentage,
            min_valid_windows=req.min_required_num_windows,
        )
        return self._partition_agg.meets(options)

    @property
    def generation(self) -> int:
        """Model generation: bumps when windows or topology change."""
        return self._partition_agg.generation + self._metadata.generation

    # -- model assembly --------------------------------------------------------

    def acquire_for_model_generation(self, timeout_s: float = 60.0):
        """Fairness semaphore around model builds (LoadMonitor:357)."""
        acquired = self._model_semaphore.acquire(timeout=timeout_s)
        if not acquired:
            raise TimeoutError("could not acquire model-generation semaphore")

        class _Release:
            def __enter__(inner):
                return inner

            def __exit__(inner, *exc):
                self._model_semaphore.release()
                return False

        return _Release()

    def cluster_model(
        self,
        requirements: ModelCompletenessRequirements = ModelCompletenessRequirements(),
        allow_capacity_estimation: bool = True,
    ) -> tuple:
        """Build (FlatClusterModel, ClusterMetadata) from current windows.

        The flattening pass of LoadMonitor.clusterModel (:422-487): topology
        arrays come straight from metadata; part_load comes from the window
        aggregation, leader/follower split via the CPU attribution model."""
        from cruise_control_torch.common.tracing import TRACER

        with TRACER.span("cluster-model-creation", kind="monitor") as span:
            model, meta = self._build_cluster_model(requirements, span)
        return model, meta

    def _build_cluster_model(self, requirements: ModelCompletenessRequirements, span):
        t0 = self._clock()
        topo = self._metadata.refresh_metadata()
        self._ensure_universe(topo)

        try:
            agg = self._partition_agg.aggregate(
                options=AggregationOptions(
                    min_valid_entity_ratio=requirements.min_monitored_partitions_percentage,
                    min_valid_windows=requirements.min_required_num_windows,
                )
            )
        except ValueError as e:
            # a cold aggregator ("no samples added yet" / "no completed
            # windows yet") is a completeness condition, not an internal
            # error — surface it typed so the REST tier answers 503
            raise NotEnoughValidWindowsError(str(e), {
                "validPartitionRatio": 0.0,
                "requiredPartitionRatio": requirements.min_monitored_partitions_percentage,
                "validWindows": 0,
                "requiredWindows": requirements.min_required_num_windows,
            }) from e
        c = agg.completeness
        completeness = {
            "validPartitionRatio": round(float(c.valid_entity_ratio), 4),
            "requiredPartitionRatio": requirements.min_monitored_partitions_percentage,
            "validWindows": len(c.valid_windows),
            "requiredWindows": requirements.min_required_num_windows,
        }
        if c.valid_entity_ratio < requirements.min_monitored_partitions_percentage:
            raise NotEnoughValidPartitionsError(
                f"not enough valid partitions: {c.valid_entity_ratio:.3f} < "
                f"{requirements.min_monitored_partitions_percentage:.3f}",
                completeness,
            )
        if len(c.valid_windows) < requirements.min_required_num_windows:
            raise NotEnoughValidWindowsError(
                f"not enough valid windows: {len(c.valid_windows)} < "
                f"{requirements.min_required_num_windows}",
                completeness,
            )

        values = agg.values  # f32[P, W, M_common]
        # windows -> expected utilization (Load.expectedUtilizationFor):
        # AVG metrics average over windows; LATEST (disk) takes the newest.
        win_avg = values.mean(axis=1)  # [P, M]
        disk = values[:, -1, KafkaMetricDef.DISK_USAGE]
        cpu = win_avg[:, KafkaMetricDef.CPU_USAGE]
        l_in = win_avg[:, KafkaMetricDef.LEADER_BYTES_IN]
        l_out = win_avg[:, KafkaMetricDef.LEADER_BYTES_OUT]

        part_load = np.zeros((topo.num_partitions, NUM_PART_METRICS), dtype=np.float32)
        part_load[:, PartMetric.CPU_LEADER] = cpu
        part_load[:, PartMetric.CPU_FOLLOWER] = follower_cpu_util_from_leader_load(
            l_in, l_out, cpu
        )
        part_load[:, PartMetric.NW_IN_LEADER] = l_in
        part_load[:, PartMetric.NW_IN_FOLLOWER] = l_in  # replication pulls leader input
        part_load[:, PartMetric.NW_OUT_LEADER] = l_out
        part_load[:, PartMetric.DISK] = disk

        capacities = np.stack(
            [self._capacity.capacity_for_broker(int(bid)) for bid in topo.broker_ids]
        )

        # the port's model on the host, as the JAX monitor builds its model
        # of numpy arrays: the optimizer, the entry point on the card, moves it
        model = from_numpy(dict(
            assignment=np.asarray(topo.assignment, dtype=np.int32),
            part_load=part_load,
            topic_id=np.asarray(topo.topic_id, dtype=np.int32),
            broker_capacity=capacities.astype(np.float32),
            broker_rack=np.asarray(topo.broker_rack, dtype=np.int32),
            broker_host=np.asarray(topo.broker_host, dtype=np.int32),
            broker_state=np.asarray(topo.broker_state, dtype=np.int32),
        ), device="cpu")
        meta = ClusterMetadata(
            topic_names=tuple(topo.topic_names),
            partition_index=np.asarray(topo.partition_index, dtype=np.int32),
            broker_ids=np.asarray(topo.broker_ids, dtype=np.int32),
            topic_of_partition=np.asarray(topo.topic_id, dtype=np.int32),
        )
        self.sensors["model_creations"] += 1
        self.sensors["model_creation_time_s"] += self._clock() - t0
        from cruise_control_torch.common.sensors import REGISTRY

        # hot timer -> histogram: /metrics serves p50/p95/p99 of model builds
        REGISTRY.histogram("LoadMonitor.cluster-model-creation-timer").record(
            self._clock() - t0
        )
        span.attributes.update(
            brokers=int(topo.num_brokers),
            partitions=int(topo.num_partitions),
            generation=int(self.generation),
        )
        return model, meta

