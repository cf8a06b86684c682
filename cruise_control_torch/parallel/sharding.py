"""Shape bucketing: pad a model's partition and broker axes up to a bucket.

The host-side padding helpers of the JAX package's parallel/sharding.py
(`pad_partitions_to` :88, `size_bucket` :120, `geom_bucket` :138,
`pad_brokers_to` :162), copied without the mesh placement. They work on a
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

import torch

from cruise_control_torch.common.resources import BrokerState
from cruise_control_torch.models.flat_model import FlatClusterModel


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
