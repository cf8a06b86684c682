"""Optimizer context: static inputs and incrementally-updated aggregates.

`StaticCtx` carries everything constant across an optimization run (the
flattened cluster inputs, constraint thresholds and the option masks),
`Aggregates` the per-broker/per-rack/per-topic summaries the goals consult.
Aggregates are computed from the assignment by K1 (kernels.segment_aggregates)
and updated wave by wave by K4 (kernels.apply_wave), which writes the
aggregate tensors in place: a round never reads an older aggregate state, so
the JAX package's functional copies are not needed.
"""

from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from cruise_control_torch.common.resources import BrokerState, Resource
from cruise_control_torch.config.balancing import BalancingConstraint
from cruise_control_torch.kernels.apply_wave import (  # noqa: F401  (re-exported)
    apply_actions_batch,
    apply_wave,
    wave_select,
)
from cruise_control_torch.kernels.segment_aggregates import segment_aggregates
from cruise_control_torch.models.flat_model import FlatClusterModel


@dataclasses.dataclass(frozen=True)
class OptimizationOptions:
    """Mask-encoded request options (cc/analyzer/OptimizationOptions.java:14),
    with the JAX package's fields. The `*_pattern` / `*_ids` fields are
    symbolic: `resolve_options` turns them into masks once the model exists."""

    #: replicas of these partitions may not move (excluded topics)
    excluded_partitions: Optional[np.ndarray] = None  # bool[P]
    #: these brokers may not receive leadership
    excluded_brokers_for_leadership: Optional[np.ndarray] = None  # bool[B]
    #: these brokers may not receive replicas
    excluded_brokers_for_replica_move: Optional[np.ndarray] = None  # bool[B]
    #: if set, only these brokers receive replicas
    requested_destination_brokers: Optional[np.ndarray] = None  # bool[B]
    #: self-healing: only replicas on dead brokers move
    only_move_immigrants: bool = False
    #: triggered by the goal-violation detector: the distribution goals'
    #: margins widen by the constraint's multiplier
    is_triggered_by_goal_violation: bool = False
    #: regex over topic names; the matching topics' partitions may not move
    excluded_topic_pattern: Optional[str] = None
    #: broker ids that are the only destinations
    destination_broker_ids: Optional[tuple] = None


def resolve_options(options: OptimizationOptions, model: FlatClusterModel,
                    topic_names: Optional[Sequence[str]] = None) -> OptimizationOptions:
    """The options with their symbolic fields turned into masks for this
    model's axes (context.py:58): `excluded_topic_pattern` (full matches
    against `topic_names`, indexed by topic id; `generators.topic_names`
    names a generated model's topics) into `excluded_partitions`, OR-ed with
    any given, and `destination_broker_ids` into
    `requested_destination_brokers`, AND-ed with any given."""
    out = options
    if options.excluded_topic_pattern is not None:
        if topic_names is None:
            raise ValueError("excluded_topic_pattern requires topic names (monitor-built model)")
        rx = re.compile(options.excluded_topic_pattern)
        excluded_topics = np.array([bool(rx.fullmatch(name)) for name in topic_names], dtype=bool)
        mask = excluded_topics[model.topic_id.cpu().numpy()]
        if options.excluded_partitions is not None:
            mask = mask | np.asarray(options.excluded_partitions, dtype=bool)
        out = dataclasses.replace(out, excluded_partitions=mask, excluded_topic_pattern=None)
    if options.destination_broker_ids is not None:
        bad = [b for b in options.destination_broker_ids if b < 0 or b >= model.num_brokers]
        if bad:
            raise ValueError(f"destination_broker_ids out of range [0, {model.num_brokers}): {bad}")
        dst = np.zeros(model.num_brokers, dtype=bool)
        dst[list(options.destination_broker_ids)] = True
        if out.requested_destination_brokers is not None:
            dst = dst & np.asarray(out.requested_destination_brokers, dtype=bool)
        out = dataclasses.replace(out, requested_destination_brokers=dst,
                                  destination_broker_ids=None)
    return out


class StaticCtx(NamedTuple):
    """Run-constant tensors; scalar fields are 0-d tensors on the device."""

    part_load: torch.Tensor  # f32[P, M]
    topic_id: torch.Tensor  # i32[P]
    broker_capacity: torch.Tensor  # f32[B, 4]
    capacity_limit: torch.Tensor  # f32[B, 4] capacity * capacity.threshold
    broker_rack: torch.Tensor  # i32[B]
    broker_host: torch.Tensor  # i32[B]
    broker_state: torch.Tensor  # i32[B]
    alive: torch.Tensor  # bool[B]
    dead: torch.Tensor  # bool[B]
    new: torch.Tensor  # bool[B]
    demoted: torch.Tensor  # bool[B]
    replica_dst_ok: torch.Tensor  # bool[B]
    leadership_dst_ok: torch.Tensor  # bool[B]
    movable_partition: torch.Tensor  # bool[P]
    host_cpu_capacity_limit: torch.Tensor  # f32[H]
    broker_valid: torch.Tensor  # bool[B]
    num_valid_partitions: torch.Tensor  # f32[]
    resource_balance_pct: torch.Tensor  # f32[4]
    low_utilization_threshold: torch.Tensor  # f32[4]
    replica_balance_pct: torch.Tensor  # f32[]
    leader_replica_balance_pct: torch.Tensor  # f32[]
    topic_replica_balance_pct: torch.Tensor  # f32[]
    max_replicas_per_broker: torch.Tensor  # i32[]
    only_move_immigrants: torch.Tensor  # bool[]


class Aggregates(NamedTuple):
    """Summaries of the current assignment, updated in place by apply waves."""

    assignment: torch.Tensor  # i32[P, R]
    broker_load: torch.Tensor  # f32[B, 4]
    replica_count: torch.Tensor  # i32[B]
    leader_count: torch.Tensor  # i32[B]
    potential_nw_out: torch.Tensor  # f32[B]
    leader_nw_in: torch.Tensor  # f32[B]
    rack_replica_count: torch.Tensor  # i32[P, NR]
    topic_replica_count: torch.Tensor  # i32[T, B]
    host_cpu_load: torch.Tensor  # f32[H]
    #: packed (round, wave) tag of the last accepted action that wrote each
    #: assignment cell (`make_touch_tag`; -1 = never touched this run)
    touch_tag: torch.Tensor  # i32[P, R]


#: touch-tag packing width: `tag = round * TAG_WAVE_BASE + wave`
TAG_WAVE_BASE = 1024


def make_touch_tag(rnd: int, wave: int) -> int:
    """Packed (round, wave) provenance tag of an apply site (an int32 value)."""
    tag = int(rnd) * TAG_WAVE_BASE + int(wave)
    if not -(2**31) <= tag < 2**31:
        raise OverflowError(f"touch tag {tag} does not fit int32")
    return tag


@dataclasses.dataclass(frozen=True)
class Dims:
    """Problem dimensions (python ints)."""

    num_partitions: int
    max_rf: int
    num_brokers: int
    num_racks: int
    num_hosts: int
    num_topics: int


def dims_of(model: FlatClusterModel) -> Dims:
    def count(t):
        return int(t.max()) + 1 if t.numel() else 0

    return Dims(
        num_partitions=model.num_partitions,
        max_rf=model.max_replication_factor,
        num_brokers=model.num_brokers,
        num_racks=count(model.broker_rack),
        num_hosts=count(model.broker_host),
        num_topics=count(model.topic_id),
    )


def build_static_ctx(
    model: FlatClusterModel,
    constraint: BalancingConstraint,
    dims: Dims,
    options: OptimizationOptions = OptimizationOptions(),
    valid_brokers: Optional[int] = None,
    valid_partitions: Optional[int] = None,
) -> StaticCtx:
    """The run's static context on the model's device (context.py:195). The
    broker-sized arrays are derived on the CPU (the host CPU capacity sum
    then runs in broker order, as in the reference) and moved once. The
    options' masks must be resolved (`resolve_options`) and as long as the
    model's axes. `valid_brokers` / `valid_partitions`: the counts of real
    rows of a model padded to a shape bucket (the padding is appended, so a
    prefix count suffices); None when every row is real. Padded brokers are
    neither alive nor dead."""
    dev = model.device
    b = dims.num_brokers
    state = model.broker_state.cpu()
    valid = torch.arange(b) < (b if valid_brokers is None else valid_brokers)
    alive = (state != BrokerState.DEAD) & valid
    demoted = (state == BrokerState.DEMOTED) & valid

    def mask(arr, default: bool) -> torch.Tensor:
        if arr is None:
            return torch.full((b,), default)
        return torch.as_tensor(np.asarray(arr, dtype=bool))

    replica_dst_ok = alive & ~mask(options.excluded_brokers_for_replica_move, False)
    if options.requested_destination_brokers is not None:
        replica_dst_ok = replica_dst_ok & mask(options.requested_destination_brokers, True)
    leadership_dst_ok = alive & ~demoted & ~mask(options.excluded_brokers_for_leadership, False)
    if options.excluded_partitions is None:
        movable = torch.ones(dims.num_partitions, dtype=torch.bool)
    else:
        movable = ~torch.as_tensor(np.asarray(options.excluded_partitions, dtype=bool))

    effective = constraint
    if options.is_triggered_by_goal_violation:
        effective = constraint.with_multiplier_applied()

    capacity = model.broker_capacity.cpu()
    cap_threshold = torch.as_tensor(np.asarray(effective.capacity_threshold, dtype=np.float32))
    capacity_limit = capacity * cap_threshold[None, :]
    host_cpu_cap = torch.zeros(dims.num_hosts, dtype=torch.float32).index_add_(
        0, model.broker_host.cpu().long(), capacity[:, Resource.CPU])

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    return StaticCtx(
        part_load=model.part_load,
        topic_id=model.topic_id,
        broker_capacity=capacity.to(dev),
        capacity_limit=capacity_limit.to(dev),
        broker_rack=model.broker_rack,
        broker_host=model.broker_host,
        broker_state=model.broker_state,
        alive=alive.to(dev),
        dead=((state == BrokerState.DEAD) & valid).to(dev),
        new=((state == BrokerState.NEW) & valid).to(dev),
        demoted=demoted.to(dev),
        replica_dst_ok=replica_dst_ok.to(dev),
        leadership_dst_ok=leadership_dst_ok.to(dev),
        movable_partition=movable.to(dev),
        host_cpu_capacity_limit=(host_cpu_cap * cap_threshold[Resource.CPU]).to(dev),
        broker_valid=valid.to(dev),
        num_valid_partitions=f32(dims.num_partitions if valid_partitions is None
                                 else valid_partitions),
        resource_balance_pct=f32(effective.resource_balance_percentage),
        low_utilization_threshold=f32(effective.low_utilization_threshold),
        replica_balance_pct=f32(effective.replica_balance_percentage),
        leader_replica_balance_pct=f32(effective.leader_replica_balance_percentage),
        topic_replica_balance_pct=f32(effective.topic_replica_balance_percentage),
        max_replicas_per_broker=torch.tensor(int(effective.max_replicas_per_broker),
                                             dtype=torch.int32, device=dev),
        only_move_immigrants=torch.tensor(bool(options.only_move_immigrants), device=dev),
    )


def compute_aggregates(static: StaticCtx, assignment: torch.Tensor, dims: Dims) -> Aggregates:
    """All aggregates of `assignment` (K1). The assignment is copied: the
    apply waves write the returned aggregates in place."""
    assignment = assignment.clone()
    outs = segment_aggregates(
        assignment, static.part_load, static.topic_id, static.broker_rack, static.broker_host,
        dims.num_brokers, dims.num_racks, dims.num_hosts, dims.num_topics,
    )
    return Aggregates(assignment, *outs, touch_tag=torch.full_like(assignment, -1))


def utilization(agg: Aggregates, static: StaticCtx) -> torch.Tensor:
    """f32[B, 4] load / capacity."""
    floor = torch.tensor(1e-9, dtype=torch.float32, device=static.broker_capacity.device)
    return agg.broker_load / torch.maximum(static.broker_capacity, floor)


def replicas_on_dead(static: StaticCtx, assignment: torch.Tensor) -> torch.Tensor:
    """bool[P, R]: slots whose replica currently sits on a dead broker
    (empty slots are clamped to broker 0 for the gather and masked out)."""
    valid = assignment >= 0
    return static.dead[torch.where(valid, assignment, 0).long()] & valid


def rank_paired_destinations(valid_src: torch.Tensor, dst_key: torch.Tensor,
                             offset: int) -> torch.Tensor:
    """i32[B]: pair the i-th valid source broker (by broker id) with the
    (i + offset)-th best destination by `dst_key` (higher = better, -inf =
    ineligible), wrapping over the feasible prefix (context.py:502). The
    ranking is a stable descending sort: ties go to the lower broker id."""
    rank = torch.sort(-dst_key, stable=True).indices.to(torch.int32)
    n_feasible = torch.clamp(torch.sum(torch.isfinite(dst_key).to(torch.int64)), min=1)
    rr = torch.cumsum(valid_src.to(torch.int64), dim=0) - 1
    return rank[(rr + offset) % n_feasible]


def dst_hosts_partition(agg: Aggregates, p: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """bool[...]: does dst already host a replica of p (any slot)?"""
    row = agg.assignment[p.long()]
    return torch.any(row == dst[..., None], dim=-1)
