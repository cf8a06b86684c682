"""The incremental re-proposal lane: model deltas scattered into the armed
static context, then a goal-scoped re-solve (the JAX package's
analyzer/incremental.py).

When the monitor reports a dead broker, a load spike or new partitions after
a full solve, the lane does not rebuild the model:

  1. `derive_deltas` diffs the fresh model against the one the last solve
     ran on into typed `ModelDelta`s (broker death, revival or state change,
     load spike, partition add). What a row scatter cannot express (a
     capacity or topology edit, the row shift of a topic delete, growth past
     the shape bucket) becomes a fallback reason instead.
  2. K10 (`kernels.delta_scatter`) writes the batch into a copy of the
     static context armed from the optimizer's prep cache and recomputes
     the state-derived broker masks with build_static_ctx's expressions, so
     the new context equals a build from scratch on the perturbed model.
  3. `SENSITIVITY` names the goals each kind of delta can violate, and the
     lane re-solves only those, through the full-stack machine's enabled
     mask, from the live placement.

The contract: the goals outside the affected set make no move, and the
scoped solve's decision digest equals a scratch solve of the same subset on
the same perturbed model, since both run `GoalOptimizer._solve_prepared` on
equal inputs. Anything the lane cannot do in place is a typed fallback
reason; it never guesses.

The lane marks the JAX lane's sensors (common/sensors.py: `Incremental.*`)
and opens its `incremental-delta-apply` span (common/tracing.py). The facade
(facade.py) arms it after every stamped solve and reads its knobs from the
service configuration (`IncrementalConfig.from_config`). On an optimizer
with a partition-axis mesh, K10 scatters into the canonical (unplaced)
context and the result is placed on the mesh again (the JAX lane's
:593-596).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cruise_control_torch.analyzer.context import OptimizationOptions, StaticCtx
from cruise_control_torch.common.resources import BrokerState
from cruise_control_torch.common.sensors import REGISTRY
from cruise_control_torch.common.tracing import TRACER
from cruise_control_torch.kernels.delta_scatter import (  # noqa: F401  (KIND_NOOP re-exported)
    KIND_LOAD,
    KIND_NOOP,
    KIND_PART_ADD,
    KIND_STATE,
    delta_scatter,
)
from cruise_control_torch.models.flat_model import FlatClusterModel
from cruise_control_torch.parallel.sharding import place_static

# -- the delta vocabulary ------------------------------------------------------

DELTA_BROKER_DEATH = "broker_death"
DELTA_BROKER_REVIVAL = "broker_revival"
DELTA_BROKER_STATE = "broker_state"  # NEW / DEMOTED transitions
DELTA_LOAD_SPIKE = "load_spike"
DELTA_PART_ADD = "part_add"
DELTA_TOPIC_DELETE = "topic_delete"

DELTA_KINDS = (DELTA_BROKER_DEATH, DELTA_BROKER_REVIVAL, DELTA_BROKER_STATE, DELTA_LOAD_SPIKE,
               DELTA_PART_ADD, DELTA_TOPIC_DELETE)

#: the batch's kind code of each delta kind: every state transition shares
#: one, since the scatter recomputes every state-derived mask
_KERNEL_KIND = {
    DELTA_BROKER_DEATH: KIND_STATE,
    DELTA_BROKER_REVIVAL: KIND_STATE,
    DELTA_BROKER_STATE: KIND_STATE,
    DELTA_LOAD_SPIKE: KIND_LOAD,
    DELTA_PART_ADD: KIND_PART_ADD,
}


@dataclasses.dataclass(frozen=True)
class ModelDelta:
    """One typed model change. State kinds carry (broker, state); a load
    spike carries (row, load), the fresh model's exact f32 row (a
    replacement, not a multiplier, so the scattered row equals a build from
    scratch bit for bit); a partition add carries (row, topic, load) and
    fills a padded row; a topic delete carries only its kind (it is never
    applied in place)."""

    kind: str
    broker: int = -1
    state: int = -1
    row: int = -1
    topic: int = -1
    load: Optional[np.ndarray] = None  # f32[M]

    def __post_init__(self):
        if self.kind not in DELTA_KINDS:
            raise ValueError(f"unknown delta kind {self.kind!r}")


class DeltaBatch(NamedTuple):
    """A delta list in K10's fixed shape: `max_deltas` rows, NOOP-padded."""

    kind: torch.Tensor  # i32[D]
    broker: torch.Tensor  # i32[D]
    state: torch.Tensor  # i32[D]
    row: torch.Tensor  # i32[D]
    topic: torch.Tensor  # i32[D]
    load: torch.Tensor  # f32[D, M]


def build_delta_batch(deltas: Sequence[ModelDelta], max_deltas: int, num_metrics: int,
                      device="cpu") -> DeltaBatch:
    """Pack host deltas into the fixed-shape batch (NOOP rows are zeros) and
    move it to `device` once."""
    d = max_deltas
    cols = {name: np.zeros(d, np.int32) for name in ("kind", "broker", "state", "row", "topic")}
    load = np.zeros((d, num_metrics), np.float32)
    for i, dl in enumerate(deltas):
        cols["kind"][i] = _KERNEL_KIND[dl.kind]
        for name in ("broker", "state", "row", "topic"):
            cols[name][i] = getattr(dl, name)
        if dl.load is not None:
            load[i] = np.asarray(dl.load, dtype=np.float32)
    return DeltaBatch(**{k: torch.from_numpy(v).to(device) for k, v in cols.items()},
                      load=torch.from_numpy(load).to(device))


# -- delta derivation ----------------------------------------------------------

#: fallback reasons
FALLBACK_DISABLED = "DISABLED"
FALLBACK_NOT_ARMED = "NOT_ARMED"
FALLBACK_STALE_GENERATION = "STALE_GENERATION"
FALLBACK_SHAPE_RF = "SHAPE_RF"
FALLBACK_SHAPE_BROKERS = "SHAPE_BROKERS"
FALLBACK_SHAPE_BUCKET = "SHAPE_BUCKET"
FALLBACK_SHAPE_TOPICS = "SHAPE_TOPICS"
FALLBACK_STRUCTURAL = "STRUCTURAL"
FALLBACK_STRUCTURAL_SHIFT = "STRUCTURAL_SHIFT"
FALLBACK_TOO_MANY_DELTAS = "TOO_MANY_DELTAS"
FALLBACK_SENSITIVITY_ALL = "SENSITIVITY_ALL"
FALLBACK_OPTIONS = "OPTIONS"
FALLBACK_NO_DELTAS = "NO_DELTAS"


def derive_deltas(old: FlatClusterModel,
                  new: FlatClusterModel) -> Tuple[List[ModelDelta], Optional[str]]:
    """Diff two unpadded models into typed deltas (incremental.py:243).
    Returns (deltas, fallback_reason); a reason means the change is not a set
    of row scatters and the caller must solve from scratch. Host numpy on
    copies of the models."""
    if new.max_replication_factor != old.max_replication_factor:
        return [], FALLBACK_SHAPE_RF
    if new.num_brokers != old.num_brokers:
        return [], FALLBACK_SHAPE_BROKERS
    o = {k: v.cpu().numpy() for k, v in old._asdict().items()}
    n = {k: v.cpu().numpy() for k, v in new._asdict().items()}
    if any(not np.array_equal(o[k], n[k]) for k in ("broker_capacity", "broker_rack",
                                                     "broker_host")):
        return [], FALLBACK_STRUCTURAL
    p_old, p_new = old.num_partitions, new.num_partitions
    if p_new < p_old:
        # a topic delete shifts every later row: no scatter expresses it,
        # and SENSITIVITY maps the marker to a fallback
        return [ModelDelta(kind=DELTA_TOPIC_DELETE)], None
    if not np.array_equal(o["topic_id"], n["topic_id"][:p_old]):
        return [], FALLBACK_STRUCTURAL_SHIFT

    deltas: List[ModelDelta] = []
    st_o, st_n = o["broker_state"], n["broker_state"]
    for b in np.nonzero(st_o != st_n)[0]:
        ns = int(st_n[b])
        if ns == BrokerState.DEAD:
            kind = DELTA_BROKER_DEATH
        elif int(st_o[b]) == BrokerState.DEAD:
            kind = DELTA_BROKER_REVIVAL
        else:
            kind = DELTA_BROKER_STATE
        deltas.append(ModelDelta(kind=kind, broker=int(b), state=ns))
    pl_o, pl_n = o["part_load"], n["part_load"]
    for r in np.nonzero(np.any(pl_o != pl_n[:p_old], axis=1))[0]:
        deltas.append(ModelDelta(kind=DELTA_LOAD_SPIKE, row=int(r), load=pl_n[r]))
    for r in range(p_old, p_new):
        deltas.append(ModelDelta(kind=DELTA_PART_ADD, row=r, topic=int(n["topic_id"][r]),
                                 load=pl_n[r]))
    return deltas, None


# -- goal sensitivity ----------------------------------------------------------

#: the delta cannot be scoped: fall back
ALL = "all"

_COUNT_GOALS = frozenset((
    "RackAwareGoal",
    "ReplicaCapacityGoal",
    "ReplicaDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
))
_LOAD_GOALS = frozenset((
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
    "PotentialNwOutGoal",
    "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal",
    "LeaderBytesInDistributionGoal",
))


def _sensitivity_map() -> Dict[str, object]:
    from cruise_control_torch.analyzer.goals import GOAL_REGISTRY, HARD_GOAL_NAMES

    all_names = frozenset(GOAL_REGISTRY)
    return {
        # a load change moves no replica and kills no broker: the count and
        # placement goals see the same assignment
        DELTA_LOAD_SPIKE: _LOAD_GOALS,
        # a dead broker strands replicas and leaves every goal's window
        DELTA_BROKER_DEATH: all_names,
        DELTA_BROKER_STATE: all_names,
        # a revived broker comes back empty: it cannot violate a hard goal
        DELTA_BROKER_REVIVAL: all_names - frozenset(HARD_GOAL_NAMES),
        # an added partition brings its load in its row; it changes counts
        # and placements
        DELTA_PART_ADD: _COUNT_GOALS,
        DELTA_TOPIC_DELETE: ALL,
    }


SENSITIVITY: Dict[str, object] = _sensitivity_map()


def affected_goals(deltas: Sequence[ModelDelta],
                   armed_goal_names: Sequence[str]) -> Optional[Tuple[str, ...]]:
    """The armed goals, in armed order, that the batch can violate; None
    when a delta cannot be scoped."""
    union: set = set()
    for d in deltas:
        sens = SENSITIVITY[d.kind]
        if sens == ALL:
            return None
        union |= set(sens)
    return tuple(n for n in armed_goal_names if n in union)


# -- configuration and outcome -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IncrementalConfig:
    """The `optimizer.incremental.*` knobs, with the service's defaults."""

    enabled: bool = True
    max_deltas: int = 64
    fallback_full: bool = True

    @classmethod
    def from_config(cls, config) -> "IncrementalConfig":
        return cls(
            enabled=config.get_boolean("optimizer.incremental.enabled"),
            max_deltas=config.get_int("optimizer.incremental.max.deltas"),
            fallback_full=config.get_boolean("optimizer.incremental.fallback.full"),
        )


@dataclasses.dataclass
class IncrementalOutcome:
    """One propose(): a scoped OptimizerResult, or a typed fallback reason."""

    result: Optional[object]  # OptimizerResult
    deltas: List[ModelDelta]
    affected: Tuple[str, ...]
    goals_skipped: int
    fallback_reason: Optional[str]
    duration_s: float

    @property
    def ok(self) -> bool:
        return self.result is not None

    def summary(self) -> Dict:
        by_kind: Dict[str, int] = {}
        for d in self.deltas:
            by_kind[d.kind] = by_kind.get(d.kind, 0) + 1
        return {
            "ok": self.ok,
            "deltas": len(self.deltas),
            "deltasByKind": by_kind,
            "affectedGoals": list(self.affected),
            "goalsSkipped": self.goals_skipped,
            "fallbackReason": self.fallback_reason,
            "durationS": round(self.duration_s, 4),
        }


@dataclasses.dataclass
class _ArmedState:
    """What the lane captured from the last full solve."""

    model: FlatClusterModel  # the unpadded model that solve ran on
    options: OptimizationOptions
    goal_names: Tuple[str, ...]
    generation: Optional[int]
    p_valid: int  # real partitions (grows with partition adds)
    pmodel: FlatClusterModel  # padded host copy, kept consistent with the scatter
    dims: object
    static: StaticCtx  # on the optimizer's device
    static_canon: StaticCtx  # the copy K10 updates (`static` unplaced; the same one
    # without a mesh)
    bucketed: Dict
    base_replica_dst: torch.Tensor  # bool[B], the state-independent factors
    base_leadership_dst: torch.Tensor  # bool[B]


class IncrementalLane:
    """The incremental re-proposal lane over one GoalOptimizer: `arm()` after
    a full solve captures that solve's prep-cache entry; `propose()` turns a
    fresh model into a scoped re-solve without a rebuild."""

    def __init__(self, optimizer, config: IncrementalConfig = IncrementalConfig()):
        self._optimizer = optimizer
        self._config = config
        self._lock = threading.Lock()
        self._armed: Optional[_ArmedState] = None
        self._last: Optional[IncrementalOutcome] = None
        self._goals_skipped = 0
        REGISTRY.gauge("Incremental.goals-skipped", lambda: self._goals_skipped)

    @property
    def config(self) -> IncrementalConfig:
        return self._config

    def arm(self, model: FlatClusterModel, options: OptimizationOptions,
            goal_names: Sequence[str], generation: Optional[int] = None) -> bool:
        """Capture the prep-cache entry of a full solve. Pass the same model
        and options objects that solve took: the cache keys by identity.
        False when the lane is disabled or the entry is gone."""
        if not self._config.enabled:
            return False
        prepared_entry = getattr(self._optimizer, "prepared_entry", None)
        if prepared_entry is None:
            return False
        entry = prepared_entry(model, options)
        if entry is None:
            return False
        p_orig, pmodel, dims, static, static_canon, bucketed = entry
        b = dims.num_brokers
        valid = np.arange(b) < model.num_brokers

        def padded(mask):
            if mask is None:
                return None
            m = np.asarray(mask, dtype=bool)
            return np.concatenate([m, np.zeros(b - m.shape[0], dtype=bool)])

        base_replica = valid.copy()
        excl_rep = padded(options.excluded_brokers_for_replica_move)
        if excl_rep is not None:
            base_replica &= ~excl_rep
        req = padded(options.requested_destination_brokers)
        if req is not None:
            base_replica &= req
        base_lead = valid.copy()
        excl_lead = padded(options.excluded_brokers_for_leadership)
        if excl_lead is not None:
            base_lead &= ~excl_lead
        dev = static.broker_state.device
        with self._lock:
            self._armed = _ArmedState(
                model=model, options=options, goal_names=tuple(goal_names),
                generation=generation, p_valid=p_orig, pmodel=pmodel.to("cpu"), dims=dims,
                static=static, static_canon=static_canon, bucketed=dict(bucketed),
                base_replica_dst=torch.from_numpy(base_replica).to(dev),
                base_leadership_dst=torch.from_numpy(base_lead).to(dev),
            )
        REGISTRY.meter("Incremental.lane-armed").mark()
        return True

    def propose(self, new_model: FlatClusterModel,
                generation: Optional[int] = None) -> IncrementalOutcome:
        """Derive the deltas against the armed model, scatter them (K10) and
        re-solve the affected goals. Never raises on a lane miss: every
        ineligibility is a typed fallback outcome."""
        t0 = time.monotonic()
        if not self._config.enabled:
            return self._fallback([], FALLBACK_DISABLED, t0)
        with self._lock:
            armed = self._armed
        if armed is None:
            return self._fallback([], FALLBACK_NOT_ARMED, t0)
        if generation is not None and armed.generation is not None and (
                generation < armed.generation):
            return self._fallback([], FALLBACK_STALE_GENERATION, t0)

        deltas, reason = derive_deltas(armed.model, new_model)
        if reason is not None:
            return self._fallback(deltas, reason, t0)
        if not deltas:
            return self._fallback(deltas, FALLBACK_NO_DELTAS, t0)
        if len(deltas) > self._config.max_deltas:
            return self._fallback(deltas, FALLBACK_TOO_MANY_DELTAS, t0)
        reason = self._eligibility(armed, deltas)
        if reason is not None:
            return self._fallback(deltas, reason, t0)
        affected = affected_goals(deltas, armed.goal_names)
        if affected is None:
            return self._fallback(deltas, FALLBACK_SENSITIVITY_ALL, t0)

        with TRACER.span("incremental-delta-apply", kind="incremental", deltas=len(deltas),
                         goals=len(affected)):
            dims = armed.dims
            batch = build_delta_batch(deltas, self._config.max_deltas,
                                      armed.pmodel.part_load.shape[1],
                                      armed.static_canon.part_load.device)
            new_canon = delta_scatter(armed.static_canon, batch, armed.base_replica_dst,
                                      armed.base_leadership_dst)
            mesh = self._optimizer._mesh
            new_static = new_canon if mesh is None else place_static(new_canon, mesh)
            pmodel = self._updated_pmodel(armed, deltas, new_model)
        p_valid = new_model.num_partitions
        result = self._optimizer.incremental_optimizations(
            pmodel, dims, new_static, new_canon, dict(armed.bucketed, incremental=True),
            p_orig=p_valid, goal_names=affected, raise_on_hard_failure=False)

        skipped = len(armed.goal_names) - len(affected)
        with self._lock:
            self._armed = dataclasses.replace(
                armed, model=new_model,
                generation=generation if generation is not None else armed.generation,
                p_valid=p_valid, pmodel=pmodel, static=new_static, static_canon=new_canon)
            self._goals_skipped = skipped
        REGISTRY.meter("Incremental.deltas-applied").mark(len(deltas))
        for d in deltas:
            REGISTRY.meter(f"Incremental.deltas-applied.{d.kind}").mark()
        duration = time.monotonic() - t0
        REGISTRY.histogram("Incremental.reproposal-timer").record(duration)
        outcome = IncrementalOutcome(result=result, deltas=deltas, affected=affected,
                                     goals_skipped=skipped, fallback_reason=None,
                                     duration_s=duration)
        with self._lock:
            self._last = outcome
        return outcome

    def _eligibility(self, armed: _ArmedState, deltas: Sequence[ModelDelta]) -> Optional[str]:
        """The shape-bucket and options checks the padded context imposes."""
        dims = armed.dims
        for d in deltas:
            if d.kind == DELTA_PART_ADD:
                if d.row >= dims.num_partitions:
                    return FALLBACK_SHAPE_BUCKET
                if d.topic >= dims.num_topics:
                    return FALLBACK_SHAPE_TOPICS
                if armed.options.excluded_partitions is not None:
                    # the padded exclusion mask marks pad rows excluded
                    return FALLBACK_OPTIONS
        return None

    def _updated_pmodel(self, armed: _ArmedState, deltas: Sequence[ModelDelta],
                        new_model: FlatClusterModel) -> FlatClusterModel:
        """The host twin of the scatter: the padded model the solve computes
        its statistics and proposals from, with the same row writes and the
        fresh model's whole assignment (the solve starts from the live
        placement)."""
        pm = armed.pmodel
        part_load, topic_id, broker_state = (pm.part_load.clone(), pm.topic_id.clone(),
                                             pm.broker_state.clone())
        for d in deltas:
            code = _KERNEL_KIND[d.kind]
            if code == KIND_STATE:
                broker_state[d.broker] = d.state
            elif code in (KIND_LOAD, KIND_PART_ADD):
                part_load[d.row] = torch.from_numpy(np.asarray(d.load, dtype=np.float32))
                if code == KIND_PART_ADD:
                    topic_id[d.row] = d.topic
        target_p, rf = pm.assignment.shape
        fresh = new_model.assignment.cpu()
        assignment = torch.cat([fresh, fresh.new_full((target_p - fresh.shape[0], rf), -1)])
        return pm._replace(assignment=assignment, part_load=part_load, topic_id=topic_id,
                           broker_state=broker_state)

    def _fallback(self, deltas: List[ModelDelta], reason: str, t0: float) -> IncrementalOutcome:
        REGISTRY.meter("Incremental.fallback-to-full").mark()
        REGISTRY.meter(f"Incremental.fallback-to-full.{reason}").mark()
        outcome = IncrementalOutcome(result=None, deltas=deltas, affected=(), goals_skipped=0,
                                     fallback_reason=reason, duration_s=time.monotonic() - t0)
        with self._lock:
            self._last = outcome
        return outcome

    def state(self) -> Dict:
        """The lane's state block, as the JAX facade's `/state` shows it."""
        with self._lock:
            armed, last = self._armed, self._last
        return {
            "enabled": self._config.enabled,
            "maxDeltas": self._config.max_deltas,
            "fallbackFull": self._config.fallback_full,
            "armed": armed is not None,
            **({"generation": armed.generation, "goals": list(armed.goal_names),
                "bucket": armed.bucketed.get("bucket"), "validPartitions": armed.p_valid}
               if armed is not None else {}),
            "lastOutcome": last.summary() if last is not None else None,
        }
