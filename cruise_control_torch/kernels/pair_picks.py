"""K6: the first k movable slots of each (topic, broker) pair.

Replaces cruise_control_tpu/analyzer/drain.py pair_replica_picks (:235),
which runs k segment-min passes over T*B + 1 group ids (10.4M groups on the
2,600-broker smoke model, for 512 pairs). The pairs' brokers are distinct
(they come from a top-k over brokers), so a broker -> pair-row lookup finds
each slot's one possible row, and k passes of a per-row minimum over the
flat slot index give the same picks without the group table. The CUDA
kernel is csrc/pair_picks.cu (one pass over the slots, each inserting into
its row's k-entry list); `pair_picks_plain` is the PyTorch version.
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


#: per device: (row_of i32[>= B] at -1, lists i32[>= V * k] at INT32_MAX,
#: ticket u32[1] at 0), the kernel's scratch, which every call leaves so;
#: grown on demand. Calls on one stream use it in turn.
_SCRATCH = {}
_ARGTYPES = (build.PTR,) * 11 + (build.INT,) * 5 + (build.PTR,)


def _scratch(dev: int, b: int, vk: int):
    """The device's scratch, grown to these sizes."""
    ws = _SCRATCH.get(dev)
    if ws is None or ws[0].numel() < b or ws[1].numel() < vk:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        cuda = torch.device("cuda", dev)
        ws = (torch.full((max(b, old[0]),), -1, dtype=torch.int32, device=cuda),
              torch.full((max(vk, old[1]),), torch.iinfo(torch.int32).max, dtype=torch.int32,
                         device=cuda),
              torch.zeros(1, dtype=torch.int32, device=cuda))
        _SCRATCH[dev] = ws
    return ws


def pair_picks(assignment, topic_id, movable_partition, pair_t, pair_b, k: int,
               num_brokers: int):
    """`pair_picks_plain` for CPU tensors, the CUDA kernel for CUDA tensors:
    two launches, one pass over the slots and the picks' write-out (up to
    12,288 brokers; above, the pair rows' table, then the pass, whose last
    block writes the picks: csrc/pair_picks.cu)."""
    if assignment.device.type == "cpu":
        return pair_picks_plain(assignment, topic_id, movable_partition, pair_t, pair_b, k,
                                num_brokers)
    dev = assignment.device
    if pair_t.dtype != torch.int32 or not pair_t.is_contiguous():
        pair_t = pair_t.to(torch.int32).contiguous()
    if pair_b.dtype != torch.int32 or not pair_b.is_contiguous():
        pair_b = pair_b.to(torch.int32).contiguous()
    if not (assignment.is_cuda and assignment.dtype == torch.int32 and assignment.dim() == 2
            and topic_id.dtype == torch.int32 and movable_partition.dtype == torch.bool
            and topic_id.shape[0] == movable_partition.shape[0] == assignment.shape[0]
            and pair_t.dim() == pair_b.dim() == 1 and pair_t.shape[0] == pair_b.shape[0]
            and topic_id.device == movable_partition.device == pair_t.device == pair_b.device
            == dev and assignment.is_contiguous() and topic_id.is_contiguous()
            and movable_partition.is_contiguous()):
        build.require(assignment, torch.int32, 2, "assignment", dev)
        build.require(topic_id, torch.int32, 1, "topic_id", dev)
        build.require(movable_partition, torch.bool, 1, "movable_partition", dev)
        build.require(pair_t, torch.int32, 1, "pair_t", dev)
        build.require(pair_b, torch.int32, 1, "pair_b", dev)
        raise ValueError("pair_picks: assignment, topic_id, movable_partition, pair_t and "
                         "pair_b disagree")
    p_count, r = assignment.shape
    v = pair_t.shape[0]
    if k < 1 or p_count * r >= 2**31 - 1:
        raise ValueError("pair_picks: needs k >= 1 and fewer than 2**31 - 1 slots")
    idx = assignment.get_device()
    row_of, lists, ticket = _scratch(idx, num_brokers, v * k)
    out = torch.empty((2, v, k), dtype=torch.int32, device=dev)
    out_ok = torch.empty((v, k), dtype=torch.bool, device=dev)
    code = build.entry("pair_picks", _ARGTYPES)(
        assignment.data_ptr(), topic_id.data_ptr(), movable_partition.data_ptr(),
        pair_t.data_ptr(), pair_b.data_ptr(), row_of.data_ptr(), lists.data_ptr(),
        ticket.data_ptr(), out.data_ptr(), out.data_ptr() + 4 * v * k, out_ok.data_ptr(),
        p_count, r, num_brokers, v, k, build.raw_stream(idx))
    if code:
        build.check(build.load("pair_picks"), code, "pair_picks")
    pair_picks.launches += 1
    out_p, out_s = out.unbind(0)
    return out_p, out_s, out_ok


pair_picks.launches = 0
