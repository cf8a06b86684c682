"""K4: pick a conflict-free subset of one wave of actions and apply it.

Replaces cruise_control_tpu/analyzer/context.py wave_select (:425) and
apply_actions_batch (:525), for single actions and for the two-leg swaps and
relays (swaps.py:293-298, drain.py:610-615, :862-867). The CUDA kernel is
csrc/apply_wave.cu; `apply_wave_plain` (= build_selected + `wave_select` +
`apply_actions_batch`) is the PyTorch version. Both write the aggregate
tensors in place.
"""

from __future__ import annotations

import torch

from cruise_control_torch.analyzer.actions import KIND_MOVE, build_selected
from cruise_control_torch.common.resources import Resource
from cruise_control_torch.kernels import build

#: the kernel's block configuration takes waves of up to BLOCK_ENTRIES
#: entries over up to BLOCK_GROUPS brokers and hosts (entries and tables in
#: shared memory; the bulk planner's waves hold one entry per broker, 3,072 on
#: the bucketed smoke model); any larger wave takes its wide configuration
#: (csrc/apply_wave.cu)
BLOCK_ENTRIES = 4096
BLOCK_GROUPS = 8192
#: per device, the kernel's group tables: i32[2, >= max(P, B, H)], score
#: keys at 0 and indices at INT32_MAX, the state every launch leaves it in
_WORKSPACE = {}
#: per device, the wide configuration's per-entry scratch (bytes), grown on
#: demand; nothing in it outlives a call
_SCRATCH = {}
#: bytes of that scratch per entry (csrc/apply_wave.cu wide_scratch_bytes)
WIDE_BYTES_PER_ENTRY = 50


def _unique_per_group(sel, s, claims, n_groups: int):
    """Keep, per group id, only the best-scoring selected entry (ties by the
    lowest index), over the union of the claim arrays: an entry must win
    every group it claims."""
    n = s.shape[0]
    dev = s.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    big = n + 1
    claims = [torch.where(sel, c.long(), n_groups) for c in claims]
    s_sel = torch.where(sel, s, torch.tensor(-torch.inf, device=dev))
    smax = torch.full((n_groups + 1,), -torch.inf, dtype=torch.float32, device=dev)
    for c in claims:
        smax = smax.scatter_reduce(0, c, s_sel, "amax")
    c_and = sel
    for c in claims:
        c_and = c_and & (s_sel >= smax[c])
    idx_s = torch.where(c_and, idx, big)
    cmin = torch.full((n_groups + 1,), big, dtype=torch.int64, device=dev)
    for c in claims:
        cmin = cmin.scatter_reduce(0, c, idx_s, "amin")
    for c in claims:
        sel = c_and & (idx == cmin[c])
        c_and = sel
    return sel


def wave_select(score, src, dst, dst_host, valid, num_brokers: int, num_hosts: int,
                parts, num_partitions: int, dst_host2=None, brokers3=None):
    """bool[N]: a conflict-free, score-prioritized subset of the entries
    (context.py:425): every broker in at most one selected action (either
    endpoint, and the third broker of a relay), every destination host and
    every partition at most once. An entry survives iff it holds the max
    score on both its brokers (ties to the lowest index), then per broker
    over (src, dst, brokers3), per host over (dst_host, dst_host2) and per
    partition over `parts`, each over the union of its claims."""
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
    if brokers3 is not None:
        b3_c = torch.where(valid, brokers3, num_brokers).long()
        sel = _unique_per_group(sel, s, [src_c, dst_c, b3_c], num_brokers)
    hosts = [h for h in (dst_host, dst_host2) if h is not None]
    sel = _unique_per_group(sel, s, hosts, num_hosts)
    return _unique_per_group(sel, s, list(parts), num_partitions)


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


def apply_wave_plain(static, agg, p, kind, slot, dst, score, ok, tag: int, leg2=None,
                     brokers3: bool = False):
    """sel bool[N]: materialize the entries' actions on the current
    assignment, select a conflict-free subset and apply it to `agg` in place.
    With `leg2` = (p2, kind2, slot2, dst2), each entry is a coupled pair (a
    swap or a relay): both legs are built from the pre-wave assignment, the
    selection also claims leg 2's destination host and partition (and, with
    `brokers3`, its destination broker), and every selected entry's leg 1
    applies before every leg 2, as the reference's two apply_actions_batch
    calls do."""
    num_brokers = agg.broker_load.shape[0]
    host = static.broker_host
    act = build_selected(static.part_load, agg.assignment, p, kind, slot, dst)
    dst_host = host[torch.clamp(act.dst, min=0).long()]
    parts, dst_host2, b3 = (act.p,), None, None
    if leg2 is not None:
        act2 = build_selected(static.part_load, agg.assignment, *leg2)
        dst_host2 = host[torch.clamp(act2.dst, min=0).long()]
        parts = (act.p, act2.p)
        if brokers3:
            b3 = act2.dst
    sel = wave_select(score, act.src, act.dst, dst_host, ok, num_brokers,
                      agg.host_cpu_load.shape[0], parts, agg.assignment.shape[0],
                      dst_host2=dst_host2, brokers3=b3)
    apply_actions_batch(static, agg, act, sel, tag)
    if leg2 is not None:
        apply_actions_batch(static, agg, act2, sel, tag)
    return sel


_ARGTYPES = (build.PTR,) * 27 + (build.INT,) * 9 + (build.PTR,)


def _refuse(legs, score, ok, tensors):
    """Raise the first reason the kernel does not take these inputs."""
    dev = score.device
    n = score.shape[0] if score.dim() else 0
    for t, name in zip(legs, ("p", "kind", "slot", "dst", "p2", "kind2", "slot2", "dst2")):
        build.require(t, torch.int32, 1, name, dev)
        if t.shape[0] != n:
            raise ValueError(f"apply_wave: {name} has {t.shape[0]} entries, score {n}")
    build.require(score, torch.float32, 1, "score", dev)
    build.require(ok, torch.bool, 1, "ok", dev)
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("apply_wave: context tensors must be contiguous and on " + str(dev))
    raise ValueError(f"apply_wave: ok has {ok.shape[0]} entries, score {n}")


def apply_wave(static, agg, p, kind, slot, dst, score, ok, tag: int, leg2=None,
               brokers3: bool = False):
    """`apply_wave_plain` for CPU tensors, the CUDA kernel for CUDA tensors.
    `p`, `kind`, `slot`, `dst` i32[N] (and each of `leg2`'s), `score` f32[N],
    `ok` bool[N]. A flagged two-leg entry's second leg must leave the broker
    its first leg enters (every swap and relay does): the kernel claims no
    other broker, and applies each entry's legs without atomics. A wave of
    at most BLOCK_ENTRIES entries over at most BLOCK_GROUPS brokers and hosts
    takes the kernel's block configuration, any other its wide one (the same
    stages, entries and tables in global memory). The kernel's group tables
    are allocated once per device (again only for a larger model) and shared
    by launches on one stream."""
    if score.device.type == "cpu":
        return apply_wave_plain(static, agg, p, kind, slot, dst, score, ok, tag, leg2, brokers3)
    dev = score.device
    n = score.shape[0]
    if brokers3 and leg2 is None:
        raise ValueError("apply_wave: brokers3 needs a second leg")
    legs = (p, kind, slot, dst) + (tuple(leg2) if leg2 is not None else (p, kind, slot, dst))
    tensors = (agg.assignment, static.part_load, static.topic_id, static.broker_rack,
               static.broker_host, agg.broker_load, agg.replica_count, agg.leader_count,
               agg.potential_nw_out, agg.leader_nw_in, agg.rack_replica_count,
               agg.topic_replica_count, agg.host_cpu_load, agg.touch_tag)
    idx = score.get_device()
    shape = score.shape
    if not (idx >= 0 and score.dtype is torch.float32 and ok.dtype is torch.bool
            and score.dim() == 1 and ok.shape == shape and ok.get_device() == idx
            and score.is_contiguous() and ok.is_contiguous()
            and all(t.dtype is torch.int32 and t.shape == shape and t.get_device() == idx
                    and t.is_contiguous() for t in legs)
            and all(t.get_device() == idx and t.is_contiguous() for t in tensors)):
        _refuse(legs, score, ok, tensors)
    num_brokers, num_hosts = agg.broker_load.shape[0], agg.host_cpu_load.shape[0]
    groups = max(num_brokers, num_hosts)
    if n >= 2**31 - 1:
        raise ValueError(f"apply_wave: {n} entries, the kernel takes fewer than 2**31 - 1")
    slots = max(agg.assignment.shape[0], groups)
    ws = _WORKSPACE.get(dev)
    if ws is None or ws.shape[1] < slots:
        ws = torch.zeros((2, slots), dtype=torch.int32, device=dev)
        ws[1] = torch.iinfo(torch.int32).max
        _WORKSPACE[dev] = ws
    scratch = ws  # not read by the block configuration
    if n > BLOCK_ENTRIES or groups > BLOCK_GROUPS:
        scratch = _SCRATCH.get(dev)
        if scratch is None or scratch.numel() < n * WIDE_BYTES_PER_ENTRY:
            scratch = torch.empty(n * WIDE_BYTES_PER_ENTRY, dtype=torch.uint8, device=dev)
            _SCRATCH[dev] = scratch
    sel = ok.new_empty(n)
    code = build.entry("apply_wave", _ARGTYPES)(
        *(t.data_ptr() for t in legs), score.data_ptr(), ok.data_ptr(), sel.data_ptr(),
        *(t.data_ptr() for t in tensors), ws.data_ptr(), scratch.data_ptr(), n,
        agg.assignment.shape[1], agg.rack_replica_count.shape[1], num_brokers, tag,
        2 if leg2 is not None else 1, 1 if brokers3 else 0, num_hosts, ws.shape[1],
        build.raw_stream(idx))
    if code:
        build.check(build.load("apply_wave"), code, "apply_wave")
    apply_wave.launches += 1
    return sel


apply_wave.launches = 0
