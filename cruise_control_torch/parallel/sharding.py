"""The partition-axis mesh: its devices, and the shape helpers of the
partition and broker axes.

The JAX package's parallel/sharding.py on torch. The mesh is one axis over
the partitions, driven by one process (single-controller, as in JAX):

- Arrays with a leading partition axis are cut into row blocks, one a
  shard: the static context's `STATIC_SHARDED_FIELDS` (`part_load`,
  `topic_id`, `movable_partition`) and the aggregates' `AGG_SHARDED_FIELDS`
  (`assignment`, `rack_replica_count`, `touch_tag`).
- Broker-, rack- and topic-sized arrays (the aggregates' summaries, the
  goal's window, the acceptance tables) are read whole by every shard.
- The full tensors stay on the mesh's first device, where every round but
  the greedy grid's shortlist runs (parallel/spmd.py runs that one shard by
  shard). A shard on the first device reads views of its rows; a shard on
  another device reads copies.

`make_mesh` may name one device several times: a mesh of eight shards of one
card (or of the CPU) runs the same program as eight cards, which is how the
tests and chip_smoke.py drive it. The configuration path
(`make_mesh_from_config`) takes distinct cards only.

The host-side padding helpers (`pad_partitions_to` :88, `size_bucket` :120,
`geom_bucket` :138, `pad_brokers_to` :162 of the JAX module) work on a
`FlatClusterModel` of host tensors: the optimizer pads on the host and moves
the padded model to the card once.

Padding rows are inert. A padded partition has -1 in every slot and zero
load, so K1 routes its slots to the overflow segment and no candidate is
built from it. A padded broker has zero capacity and the DEAD state at the
model level, and `build_static_ctx(valid_brokers=...)` keeps it out of both
`alive` and `dead`: it is never a destination, never an evacuation source
and never in a goal's window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from cruise_control_torch.analyzer.context import Aggregates, StaticCtx
from cruise_control_torch.common.resources import BrokerState
from cruise_control_torch.models.flat_model import FlatClusterModel

PARTITION_AXIS = "partitions"

#: StaticCtx fields with a leading partition axis (the JAX package's
#: parallel/spmd.py STATIC_SHARDED_FIELDS)
STATIC_SHARDED_FIELDS = frozenset({"part_load", "topic_id", "movable_partition"})
#: Aggregates fields with a leading partition axis (AGG_SHARDED_FIELDS)
AGG_SHARDED_FIELDS = frozenset({"assignment", "rack_replica_count", "touch_tag"})


def as_device(d) -> torch.device:
    """`d` as a torch.device with its index (the current card for a bare
    "cuda")."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices() -> Tuple[torch.device, ...]:
    """Every CUDA device this process sees, in index order."""
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis mesh: the device of each shard, in shard order, and the
    axis name. Hashable, so it can key a cache."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (PARTITION_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              axis_name: str = PARTITION_AXIS) -> Mesh:
    """A mesh over the first `n_devices` of `devices` (every visible card by
    default; an explicit list may name one device several times).
    `axis_name` renames the axis (`tpu.mesh.axis.name`); parallel/spmd.py
    reads it back off the mesh."""
    devices = visible_devices() if devices is None else tuple(as_device(d) for d in devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices), (axis_name,))


def make_mesh_from_config(cfg) -> Optional[Mesh]:
    """The mesh of the `tpu.mesh.*` keys (`main --config` ->
    `GoalOptimizer(mesh=...)`). `tpu.mesh.devices`: 0 = every visible card,
    and a mesh only when there is more than one; 1 = no mesh; N > 1 = the
    first N cards (raises when fewer are visible)."""
    n = cfg.get_int("tpu.mesh.devices")
    axis = cfg.get_string("tpu.mesh.axis.name") or PARTITION_AXIS
    if n == 1:
        return None
    if n == 0:
        if len(visible_devices()) < 2:
            return None
        return make_mesh(axis_name=axis)
    return make_mesh(n, axis_name=axis)


def _rows(mesh: Mesh, p: int) -> int:
    """Rows a shard holds; raises unless the mesh divides the partition axis."""
    if p % mesh.size:
        raise ValueError(f"partition axis {p} not divisible by mesh size {mesh.size}")
    return p // mesh.size


def _to(x, device: torch.device):
    """`x` (a tensor, or a tuple tree of them) on `device`: the same objects
    where they are already there, else copies."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device, non_blocking=True)
    if isinstance(x, tuple):
        items = [_to(v, device) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _placed(tree, mesh: Mesh, cut):
    """One tree a shard: field `name` of shard i is `cut(name, t, i)` (a row
    block) or, where that is None, `t` whole, on the shard's device. A whole
    field is copied once a device."""
    whole, shards = {}, []
    for i, d in enumerate(mesh.devices):
        fields = {}
        for name in tree._fields:
            t = getattr(tree, name)
            block = cut(name, t, i)
            if block is None:
                if (d, name) not in whole:
                    whole[d, name] = _to(t, d)
                fields[name] = whole[d, name]
            else:
                fields[name] = _to(block, d)
        shards.append(type(tree)(**fields))
    return tuple(shards)


def _row_cutter(mesh: Mesh, p: int, fields):
    rows = _rows(mesh, p)
    return lambda name, t, i: t[i * rows:(i + 1) * rows] if name in fields else None


def pad_partitions_to(model: FlatClusterModel, target: int) -> FlatClusterModel:
    """Pad the partition axis up to exactly `target` rows."""
    pad = target - model.num_partitions
    if pad <= 0:
        return model
    a, load, topic = model.assignment, model.part_load, model.topic_id
    return model._replace(
        assignment=torch.cat([a, a.new_full((pad, a.shape[1]), -1)]),
        part_load=torch.cat([load, load.new_zeros((pad, load.shape[1]))]),
        topic_id=torch.cat([topic, topic.new_zeros(pad)]),
    )


def pad_partitions(model: FlatClusterModel, multiple: int) -> FlatClusterModel:
    """Pad the partition axis to a multiple of the mesh size."""
    p = model.num_partitions
    return pad_partitions_to(model, p + ((-p) % multiple))


def geom_bucket(n: int, ratio: float = 1.25, floor: int = 64) -> int:
    """Round an axis size up a geometric ladder of rungs (~`ratio` apart):
    multiples of a power-of-two step with round(1 / (ratio - 1)) rungs per
    octave. Sizes up to `floor` stay exact; (floor, 64] rounds to 64."""
    if n <= floor:
        return n
    if n <= 64:
        return 64
    g = max(2, round(1.0 / (ratio - 1.0)))
    step = max(1, (1 << (n.bit_length() - 1)) // g)
    return ((n + step - 1) // step) * step


def size_bucket(n: int) -> int:
    """The partition and topic axes' ladder: eighth-octave rungs (at most
    12.5% padding), exact up to 32."""
    return geom_bucket(n, ratio=1.125, floor=32)


#: the name the optimizer uses for the partition axis
partition_bucket = size_bucket


def pad_brokers_to(model: FlatClusterModel, target_b: int, num_racks: int,
                   num_hosts: int) -> FlatClusterModel:
    """Pad the broker axis up to exactly `target_b` rows: zero capacity, the
    DEAD state, on the padded rack and host ids when `num_racks` /
    `num_hosts` exceed the real counts (the real racks' and hosts'
    aggregates then stay as they were), else round-robin over the real ones."""
    b = model.num_brokers
    pad = target_b - b
    if pad <= 0:
        return model
    cap, rack, host, state = (model.broker_capacity, model.broker_rack, model.broker_host,
                              model.broker_state)
    nr = int(rack.max()) + 1 if rack.numel() else 0
    nh = int(host.max()) + 1 if host.numel() else 0
    idx = torch.arange(pad, dtype=torch.int64, device=rack.device)
    pad_rack = nr + idx % (num_racks - nr) if num_racks > nr else idx % max(nr, 1)
    pad_host = nh + idx % (num_hosts - nh) if num_hosts > nh else idx % max(nh, 1)
    return model._replace(
        broker_capacity=torch.cat([cap, cap.new_zeros((pad, cap.shape[1]))]),
        broker_rack=torch.cat([rack, pad_rack.to(rack.dtype)]),
        broker_host=torch.cat([host, pad_host.to(host.dtype)]),
        broker_state=torch.cat([state, state.new_full((pad,), int(BrokerState.DEAD))]),
    )


def shard_model(model: FlatClusterModel, mesh: Mesh) -> FlatClusterModel:
    """A (pre-padded) model on the mesh: its tensors whole on the first
    device. Raises unless the mesh divides the partition axis, as the JAX
    placement does."""
    _rows(mesh, model.num_partitions)
    return model.to(mesh.devices[0])


class PlacedStatic(StaticCtx):
    """A StaticCtx on the mesh's first device that holds its shards: one
    StaticCtx a shard (`shards`), its partition fields a row block (views on
    the first device, copies elsewhere) and the other fields whole (copied
    once to each other device). `_replace` gives a plain StaticCtx: a changed
    context is placed again."""

    def _replace(self, **kw) -> StaticCtx:
        return StaticCtx(*self)._replace(**kw)


def place_static(static: StaticCtx, mesh: Mesh) -> PlacedStatic:
    """The context on the mesh: its fields on the first device, and its
    shards cut once (`PlacedStatic.shards`)."""
    static = _to(StaticCtx(*static), mesh.devices[0])
    placed = PlacedStatic(*static)
    placed.mesh = mesh
    placed.shards = _placed(static, mesh, _row_cutter(mesh, static.part_load.shape[0],
                                                      STATIC_SHARDED_FIELDS))
    return placed


def static_shards(static: StaticCtx, mesh: Mesh) -> Tuple[StaticCtx, ...]:
    """The shards of a context: those `place_static` cut, else cut now."""
    if isinstance(static, PlacedStatic) and static.mesh == mesh:
        return static.shards
    return place_static(static, mesh).shards


def place_aggregates(agg: Aggregates, mesh: Mesh) -> Tuple[Aggregates, ...]:
    """One Aggregates a shard: the partition fields a row block (views on the
    first device, copies elsewhere), the summaries whole. The aggregates
    change every round, so a round cuts them anew; the views read the
    first device's tensors as the round left them."""
    return _placed(agg, mesh, _row_cutter(mesh, agg.assignment.shape[0], AGG_SHARDED_FIELDS))


def place_replicated(tree, mesh: Mesh) -> tuple:
    """`tree` (a tensor, a tuple tree of them, or None) once a shard: the same
    object on the first device's shards, one copy a device elsewhere (the
    goal's window, the acceptance tables, the destination candidates)."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = tree if d == mesh.devices[0] else _to(tree, d)
    return tuple(copies[d] for d in mesh.devices)
