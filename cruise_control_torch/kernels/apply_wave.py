"""K4: pick a conflict-free subset of one wave of actions and apply it.

Replaces cruise_control_tpu/analyzer/context.py wave_select (:425) and
apply_actions_batch (:525). The CUDA kernel is csrc/apply_wave.cu;
`apply_wave_plain` (= build_selected + `wave_select` + `apply_actions_batch`)
is the PyTorch version. Both write the aggregate tensors in place.
"""

from __future__ import annotations

import torch

from cruise_control_torch.analyzer.actions import KIND_MOVE, build_selected
from cruise_control_torch.common.resources import Resource
from cruise_control_torch.kernels import build

#: the most entries one wave may hold (one CUDA block, one thread each)
MAX_WAVE = 1024


def _unique_per_group(sel, s, group, n_groups: int):
    """Keep, per group id, only the best-scoring selected entry (ties by the
    lowest index)."""
    n = s.shape[0]
    dev = s.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    big = n + 1
    c = torch.where(sel, group.long(), n_groups)
    s_sel = torch.where(sel, s, torch.tensor(-torch.inf, device=dev))
    smax = torch.full((n_groups + 1,), -torch.inf, dtype=torch.float32, device=dev)
    smax = smax.scatter_reduce(0, c, s_sel, "amax")
    c_and = sel & (s_sel >= smax[c])
    idx_s = torch.where(c_and, idx, big)
    cmin = torch.full((n_groups + 1,), big, dtype=torch.int64, device=dev)
    cmin = cmin.scatter_reduce(0, c, idx_s, "amin")
    return c_and & (idx == cmin[c])


def wave_select(score, src, dst, dst_host, part, valid, num_brokers: int, num_hosts: int,
                num_partitions: int):
    """bool[N]: a conflict-free, score-prioritized subset of the entries:
    every broker in at most one selected action (either endpoint), every
    destination host and every partition at most once. An entry survives iff
    it holds the max score on both its brokers (ties to the lowest index),
    then per destination host, then per partition. The reference's
    `dst_host2` (swaps) and `brokers3` (leadership relays) claims come with
    slice 2 (ROADMAP.md Queue 1 item 3)."""
    n = score.shape[0]
    dev = score.device
    s = torch.where(valid, score, torch.tensor(-torch.inf, device=dev))
    src_c = torch.where(valid, src, num_brokers).long()
    dst_c = torch.where(valid, dst, num_brokers).long()
    gmax = torch.full((num_brokers + 1,), -torch.inf, dtype=torch.float32, device=dev)
    gmax = gmax.scatter_reduce(0, src_c, s, "amax").scatter_reduce(0, dst_c, s, "amax")
    cand = valid & (s >= gmax[src_c]) & (s >= gmax[dst_c])
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    big = n + 1
    idx_c = torch.where(cand, idx, big)
    imin = torch.full((num_brokers + 1,), big, dtype=torch.int64, device=dev)
    imin = imin.scatter_reduce(0, src_c, idx_c, "amin").scatter_reduce(0, dst_c, idx_c, "amin")
    sel = cand & (idx == imin[src_c]) & (idx == imin[dst_c])
    sel = _unique_per_group(sel, s, dst_host, num_hosts)
    return _unique_per_group(sel, s, part, num_partitions)


def apply_actions_batch(static, agg, act, flags, tag: int = -1) -> None:
    """Apply the flagged actions of a wave to `agg` IN PLACE.

    The flagged actions must be pairwise conflict-free (wave_select's
    contract). Only flagged entries are written, in entry order: that equals
    the reference's add-everything-times-a-0/1-weight scatters, since an
    unflagged entry adds +-0.0 (or 0) and a broker carries one flagged
    action at most."""
    n = flags.shape[0]
    w = flags
    is_move = (act.kind == KIND_MOVE).expand(n)
    p, slot = act.p.expand(n).long(), act.slot.expand(n).long()
    src, dst = act.src.expand(n).long(), act.dst.expand(n).long()
    a = agg.assignment
    old_leader = a[p, 0]
    old_holder = a[p, slot]
    val_slot = torch.where(is_move, dst.to(torch.int32), old_leader)
    lead_w = w & ~is_move
    a[p[w], slot[w]] = val_slot[w]
    a[p[lead_w], 0] = old_holder[lead_w]
    agg.touch_tag[p[w], slot[w]] = tag
    agg.touch_tag[p[lead_w], 0] = tag

    s_w, d_w = src[w], dst[w]
    dload = act.dload.expand(n, 4)[w]
    agg.broker_load.index_add_(0, s_w, -dload).index_add_(0, d_w, dload)
    drep = act.drep.expand(n)[w].to(torch.int32)
    agg.replica_count.index_add_(0, s_w, -drep).index_add_(0, d_w, drep)
    dlead = act.dleader.expand(n)[w].to(torch.int32)
    agg.leader_count.index_add_(0, s_w, -dlead).index_add_(0, d_w, dlead)
    dpnw = act.dpnw.expand(n)[w]
    agg.potential_nw_out.index_add_(0, s_w, -dpnw).index_add_(0, d_w, dpnw)
    dlnw = act.dleader_nw_in.expand(n)[w]
    agg.leader_nw_in.index_add_(0, s_w, -dlnw).index_add_(0, d_w, dlnw)

    mv = w & is_move
    pm, sm, dm = p[mv], src[mv], dst[mv]
    nr = agg.rack_replica_count.shape[1]
    rack = agg.rack_replica_count.view(-1)
    one = torch.ones(pm.shape[0], dtype=torch.int32, device=a.device)
    rack.index_add_(0, pm * nr + static.broker_rack[sm].long(), -one)
    rack.index_add_(0, pm * nr + static.broker_rack[dm].long(), one)
    b = agg.topic_replica_count.shape[1]
    topic = agg.topic_replica_count.view(-1)
    t = static.topic_id[pm].long()
    topic.index_add_(0, t * b + sm, -one).index_add_(0, t * b + dm, one)

    dcpu = dload[:, Resource.CPU]
    agg.host_cpu_load.index_add_(0, static.broker_host[s_w].long(), -dcpu)
    agg.host_cpu_load.index_add_(0, static.broker_host[d_w].long(), dcpu)


def apply_wave_plain(static, agg, p, kind, slot, dst, score, ok, tag: int):
    """sel bool[N]: materialize the entries' actions on the current
    assignment, select a conflict-free subset (broker-, destination-host- and
    partition-disjoint) and apply it to `agg` in place."""
    num_brokers = agg.broker_load.shape[0]
    act = build_selected(static.part_load, agg.assignment, p, kind, slot, dst)
    dst_host = static.broker_host[torch.clamp(act.dst, min=0).long()]
    sel = wave_select(score, act.src, act.dst, dst_host, act.p, ok, num_brokers,
                      agg.host_cpu_load.shape[0], agg.assignment.shape[0])
    apply_actions_batch(static, agg, act, sel, tag)
    return sel


def apply_wave(static, agg, p, kind, slot, dst, score, ok, tag: int):
    """`apply_wave_plain` for CPU tensors, the CUDA kernel for CUDA tensors.
    `p`, `kind`, `slot`, `dst` i32[N], `score` f32[N], `ok` bool[N]."""
    if score.device.type == "cpu":
        return apply_wave_plain(static, agg, p, kind, slot, dst, score, ok, tag)
    dev = score.device
    n = score.shape[0]
    if n > MAX_WAVE:
        raise ValueError(f"apply_wave: {n} entries, the kernel takes at most {MAX_WAVE}")
    for t, name in ((p, "p"), (kind, "kind"), (slot, "slot"), (dst, "dst")):
        build.require(t, torch.int32, 1, name, dev)
        if t.shape[0] != n:
            raise ValueError(f"apply_wave: {name} has {t.shape[0]} entries, score {n}")
    build.require(score, torch.float32, 1, "score", dev)
    build.require(ok, torch.bool, 1, "ok", dev)
    tensors = (agg.assignment, static.part_load, static.topic_id, static.broker_rack,
               static.broker_host, agg.broker_load, agg.replica_count, agg.leader_count,
               agg.potential_nw_out, agg.leader_nw_in, agg.rack_replica_count,
               agg.topic_replica_count, agg.host_cpu_load, agg.touch_tag)
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("apply_wave: context tensors must be contiguous and on " + str(dev))
    sel = torch.empty(n, dtype=torch.bool, device=dev)
    lib = build.load("apply_wave")
    code = lib.apply_wave(
        build.ptrs(p, kind, slot, dst, score, ok, sel, *tensors),
        build.ints(n, agg.assignment.shape[1], agg.rack_replica_count.shape[1],
                   agg.broker_load.shape[0], tag),
        build.stream())
    build.check(lib, code, "apply_wave")
    apply_wave.launches += 1
    return sel


apply_wave.launches = 0
