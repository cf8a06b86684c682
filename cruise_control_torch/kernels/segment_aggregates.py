"""K1: segment sums of an assignment into every aggregate the goals read.

Replaces cruise_control_tpu/analyzer/context.py compute_aggregates (:276).
The CUDA kernel is csrc/segment_aggregates.cu; `segment_aggregates_plain`
is the PyTorch version (the CPU path and the kernel's spec).
"""

from __future__ import annotations

import torch

from cruise_control_torch.common.resources import PartMetric, Resource
from cruise_control_torch.kernels import build


def segment_aggregates_plain(assignment, part_load, topic_id, broker_rack, broker_host,
                             num_brokers: int, num_racks: int, num_hosts: int,
                             num_topics: int):
    """(broker_load f32[B,4], replica_count i32[B], leader_count i32[B],
    potential_nw_out f32[B], leader_nw_in f32[B], rack_replica_count i32[P,NR],
    topic_replica_count i32[T,B], host_cpu_load f32[H]).

    Float sums run in ascending slot order (index_add_ on the CPU), the order
    of XLA:CPU's segment_sum."""
    p, r = assignment.shape
    b, nr, t = num_brokers, num_racks, num_topics
    dev = assignment.device
    valid = assignment >= 0
    seg = torch.where(valid, assignment, b).reshape(p * r).long()
    pl = part_load
    lead = torch.stack([pl[:, PartMetric.CPU_LEADER], pl[:, PartMetric.NW_IN_LEADER],
                        pl[:, PartMetric.NW_OUT_LEADER], pl[:, PartMetric.DISK]], dim=-1)
    foll = torch.stack([pl[:, PartMetric.CPU_FOLLOWER], pl[:, PartMetric.NW_IN_FOLLOWER],
                        torch.zeros_like(pl[:, 0]), pl[:, PartMetric.DISK]], dim=-1)
    is_leader = (torch.arange(r, device=dev) == 0)[None, :, None]
    contrib = torch.where(is_leader, lead[:, None, :], foll[:, None, :])
    broker_load = torch.zeros((b + 1, 4), dtype=torch.float32, device=dev).index_add_(
        0, seg, contrib.reshape(p * r, 4))[:b]
    ones = torch.ones((p * r,), dtype=torch.int32, device=dev)
    replica_count = torch.zeros(b + 1, dtype=torch.int32, device=dev).index_add_(0, seg, ones)[:b]

    leader_seg = torch.where(assignment[:, 0] >= 0, assignment[:, 0], b).long()
    leader_count = torch.zeros(b + 1, dtype=torch.int32, device=dev).index_add_(
        0, leader_seg, ones[:p])[:b]
    leader_nw_in = torch.zeros(b + 1, dtype=torch.float32, device=dev).index_add_(
        0, leader_seg, pl[:, PartMetric.NW_IN_LEADER])[:b]
    pnw = pl[:, PartMetric.NW_OUT_LEADER, None].expand(p, r).reshape(p * r)
    potential = torch.zeros(b + 1, dtype=torch.float32, device=dev).index_add_(0, seg, pnw)[:b]

    rack_of = torch.where(valid, broker_rack[torch.where(valid, assignment, 0).long()], nr)
    p_idx = torch.arange(p, dtype=torch.int64, device=dev)[:, None]
    rack_flat = (p_idx * (nr + 1) + rack_of).reshape(p * r)
    rack_replica_count = torch.zeros(p * (nr + 1), dtype=torch.int32, device=dev).index_add_(
        0, rack_flat, ones).reshape(p, nr + 1)[:, :nr]
    topic_flat = (topic_id.long()[:, None] * (b + 1) + seg.reshape(p, r)).reshape(p * r)
    topic_replica_count = torch.zeros(t * (b + 1), dtype=torch.int32, device=dev).index_add_(
        0, topic_flat, ones).reshape(t, b + 1)[:, :b]
    host_cpu = torch.zeros(num_hosts, dtype=torch.float32, device=dev).index_add_(
        0, broker_host.long(), broker_load[:, Resource.CPU])
    return (broker_load.contiguous(), replica_count.contiguous(), leader_count.contiguous(),
            potential.contiguous(), leader_nw_in.contiguous(), rack_replica_count.contiguous(),
            topic_replica_count.contiguous(), host_cpu)


def segment_aggregates(assignment, part_load, topic_id, broker_rack, broker_host,
                       num_brokers: int, num_racks: int, num_hosts: int, num_topics: int):
    """The aggregates of `segment_aggregates_plain`: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if assignment.device.type == "cpu":
        return segment_aggregates_plain(assignment, part_load, topic_id, broker_rack,
                                        broker_host, num_brokers, num_racks, num_hosts,
                                        num_topics)
    dev = assignment.device
    for t, dt, nd, name in ((assignment, torch.int32, 2, "assignment"),
                            (part_load, torch.float32, 2, "part_load"),
                            (topic_id, torch.int32, 1, "topic_id"),
                            (broker_rack, torch.int32, 1, "broker_rack"),
                            (broker_host, torch.int32, 1, "broker_host")):
        build.require(t, dt, nd, name, dev)
    p, r = assignment.shape
    if part_load.shape != (p, len(PartMetric)):
        raise ValueError(f"part_load: expected ({p}, {len(PartMetric)}), got {tuple(part_load.shape)}")
    b, nr, h, t = num_brokers, num_racks, num_hosts, num_topics
    # layout (not arithmetic): each segment's members in ascending slot order
    seg = torch.where(assignment >= 0, assignment, b).reshape(-1)
    seg_sorted, order = torch.sort(seg, stable=True)
    lseg = torch.where(assignment[:, 0] >= 0, assignment[:, 0], b)
    lseg_sorted, lorder = torch.sort(lseg, stable=True)
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    outs = (torch.empty((b, 4), **f32), torch.empty(b, **i32), torch.empty(b, **i32),
            torch.empty(b, **f32), torch.empty(b, **f32), torch.empty((p, nr), **i32),
            torch.empty((t, b), **i32), torch.empty(h, **f32))
    lib = build.load("segment_aggregates")
    code = lib.segment_aggregates(
        build.ptrs(assignment, part_load, topic_id, broker_rack, broker_host,
                   seg_sorted.contiguous(), order, lseg_sorted.contiguous(), lorder, *outs),
        build.ints(p, r, b, nr, h, t), build.stream())
    build.check(lib, code, "segment_aggregates")
    segment_aggregates.launches += 1
    return outs


segment_aggregates.launches = 0
