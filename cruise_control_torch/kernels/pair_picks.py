"""K6: the first k movable slots of each (topic, broker) pair.

Replaces cruise_control_tpu/analyzer/drain.py pair_replica_picks (:235),
which runs k segment-min passes over T*B + 1 group ids (10.4M groups on the
2,600-broker smoke model, for 512 pairs). The pairs' brokers are distinct
(they come from a top-k over brokers), so a broker -> pair-row lookup finds
each slot's one possible row, and k passes of a per-row minimum over the
flat slot index give the same picks without the group table. The CUDA
kernel is csrc/pair_picks.cu; `pair_picks_plain` is the PyTorch version.
"""

from __future__ import annotations

import torch

from cruise_control_torch.kernels import build


def _pair_row_of_broker(pair_b: torch.Tensor, num_brokers: int) -> torch.Tensor:
    """i32[B]: the pair row of each broker, -1 where it heads no pair."""
    v = pair_b.shape[0]
    rows = torch.full((num_brokers,), -1, dtype=torch.int32, device=pair_b.device)
    rows[pair_b.long()] = torch.arange(v, dtype=torch.int32, device=pair_b.device)
    return rows


def pair_picks_plain(assignment, topic_id, movable_partition, pair_t, pair_b, k: int,
                     num_brokers: int):
    """(p, slot, found), each [V, k]: the k lowest flat slot indices (p * R +
    slot) holding a movable replica of topic pair_t[v] on broker pair_b[v];
    where a pair has fewer, `found` is False and (p, slot) is the last slot.
    The V brokers must be distinct."""
    p_count, r = assignment.shape
    n = p_count * r
    v = pair_t.shape[0]
    dev = assignment.device
    row_of = _pair_row_of_broker(pair_b, num_brokers)
    a = assignment.reshape(n).long()
    held = (assignment >= 0) & movable_partition[:, None]
    row = row_of[torch.clamp(a, min=0)].long()
    topic = topic_id.long()[:, None].expand(p_count, r).reshape(n)
    mine = held.reshape(n) & (row >= 0) & (topic == pair_t.long()[torch.clamp(row, min=0)])
    seg = torch.where(mine, row, v)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    last = torch.full((v + 1,), -1, dtype=torch.int64, device=dev)
    cols = []
    for _ in range(k):
        cand = mine & (pos > last[seg])
        best = torch.full((v + 1,), n, dtype=torch.int64, device=dev)
        best = best.scatter_reduce(0, torch.where(cand, seg, v), torch.where(cand, pos, n), "amin")
        cols.append(best[:v])
        last = torch.where(best < n, best, n)
    picks = torch.stack(cols, dim=1)
    found = picks < n
    sel = torch.clamp(picks, max=n - 1)
    return (sel // r).to(torch.int32), (sel % r).to(torch.int32), found


def pair_picks(assignment, topic_id, movable_partition, pair_t, pair_b, k: int,
               num_brokers: int):
    """`pair_picks_plain` for CPU tensors, the CUDA kernel for CUDA tensors."""
    if assignment.device.type == "cpu":
        return pair_picks_plain(assignment, topic_id, movable_partition, pair_t, pair_b, k,
                                num_brokers)
    dev = assignment.device
    build.require(assignment, torch.int32, 2, "assignment", dev)
    build.require(topic_id, torch.int32, 1, "topic_id", dev)
    build.require(movable_partition, torch.bool, 1, "movable_partition", dev)
    pair_t, pair_b = pair_t.to(torch.int32).contiguous(), pair_b.to(torch.int32).contiguous()
    build.require(pair_t, torch.int32, 1, "pair_t", dev)
    build.require(pair_b, torch.int32, 1, "pair_b", dev)
    p_count, r = assignment.shape
    v = pair_t.shape[0]
    if pair_b.shape[0] != v or k < 1 or p_count * r >= 2**31 - 1:
        raise ValueError("pair_picks: pair_t/pair_b disagree, k < 1, or too many slots")
    row_of = _pair_row_of_broker(pair_b, num_brokers)
    best = torch.empty(v, dtype=torch.int32, device=dev)
    out_p = torch.empty((v, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((v, k), dtype=torch.int32, device=dev)
    out_ok = torch.empty((v, k), dtype=torch.bool, device=dev)
    lib = build.load("pair_picks")
    code = lib.pair_picks(
        build.ptrs(assignment, topic_id, movable_partition, pair_t, row_of, best, out_p, out_s,
                   out_ok),
        build.ints(p_count, r, num_brokers, v, k), build.stream())
    build.check(lib, code, "pair_picks")
    pair_picks.launches += 1
    return out_p, out_s, out_ok


pair_picks.launches = 0
