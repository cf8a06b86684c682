"""K8: the cluster statistics of a model, from the segment helpers' outputs.

Replaces cruise_control_tpu/analyzer/stats.py compute_stats (:69) with
_masked_stats (:58): masked mean / std / min / max over the alive brokers of
each resource's utilisation, the replica and leader counts and the potential
NW_OUT, plus the mean over the non-empty topics of each topic's replica-count
standard deviation across the alive brokers. The CUDA kernel is
csrc/cluster_stats.cu; `cluster_stats_plain` is the PyTorch version. Every
float sum of both is taken in XLA:CPU's order (kernels/window_sum.py), so
both are bit-equal to the jitted reference; `topic_sum` and
`window_sum.xla_sum` state the order in numpy, as the tests' spec.

The sum over 32 or fewer topics is the exception. XLA:CPU fuses it with the
per-topic square roots into one loop, which LLVM's loop vectorizer
compiles: with `TOPIC_LANES[t - 1]` lanes, lane j adds the topics j, j +
lanes, ... of the whole vectors in order, the lanes are added by halves
(lane j and lane j + lanes / 2, repeatedly), and the remaining topics are
added one by one after them; with 0 lanes the topics are added in index
order. The vectorizer's choice depends on the topic count and on whether
the broker axis is longer than 32 (the per-topic sums are then windowed);
the table was read from the LLVM IR that XLA:CPU emits on an x86-64 host
with AVX-512 and probed with crafted values (tests/test_torch_stats.py).

Outputs are packed: f32[25] in ClusterModelStats order (STAT_SLOTS) and
i32[3] (alive brokers, replicas, leaders).
"""

from __future__ import annotations

import numpy as np
import torch

from cruise_control_torch.kernels import build
from cruise_control_torch.kernels.window_sum import xla_order_sum, xla_sum

#: (field, width) of the packed f32 output, in ClusterModelStats order
STAT_SLOTS = (("resource_mean", 4), ("resource_std", 4), ("resource_min", 4),
              ("resource_max", 4), ("replica_mean", 1), ("replica_std", 1),
              ("replica_min", 1), ("replica_max", 1), ("leader_mean", 1), ("leader_std", 1),
              ("topic_replica_std", 1), ("potential_nw_out_mean", 1),
              ("potential_nw_out_max", 1))
NUM_F32 = sum(w for _, w in STAT_SLOTS)
INT_SLOTS = ("num_alive_brokers", "num_replicas", "num_leaders")
#: per device: the kernel's topic deviations and its counters (the ticket
#: and the non-empty topics, 0 between launches), with their addresses,
#: grown on demand. Calls on one stream use them in turn.
_SCRATCH = {}
_ARGTYPES = (build.PTR,) * 11 + (build.INT,) * 3 + (build.PTR,)

_F = np.float32

#: lanes of the vectorized sum over t <= 32 topics, by t - 1: broker axes of
#: at most 32 brokers, and longer ones (module docstring)
TOPIC_LANES = {
    False: (0, 0, 0, 4, 0, 0, 0, 8, 0, 0, 0, 0, 0, 0, 0, 8,
            8, 8, 8, 4, 4, 4, 4, 8, 8, 8, 8, 8, 8, 8, 8, 8),
    True: (0, 2, 0, 4, 0, 0, 0, 8, 0, 0, 0, 0, 0, 0, 0, 8,
           8, 8, 8, 4, 4, 4, 4, 8, 8, 8, 8, 4, 4, 4, 4, 8),
}


def topic_sum(values: np.ndarray, num_brokers: int) -> np.float32:
    """The f32 sum of the per-topic deviations in XLA:CPU's order: windowed
    above 32 topics (`xla_sum`), else vectorized as TOPIC_LANES says."""
    t = values.shape[0]
    if t > 32 or t == 1:
        return _F(xla_sum(values))
    lanes = TOPIC_LANES[num_brokers > 32][t - 1]
    acc = np.zeros(max(lanes, 1), dtype=_F)
    main = t - t % lanes if lanes else 0
    for i in range(main):
        acc[i % lanes] = acc[i % lanes] + values[i]
    # cclint: disable=cuda-shape-branch -- the plain version's summation order (XLA's), the CPU spec of the kernel; the card runs the kernel
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = acc[:h] + acc[h:]
    s = acc[0]
    for i in range(main, t):
        s = _F(s + values[i])
    return _F(s)


def topic_order_sum(values: torch.Tensor, num_brokers: int) -> torch.Tensor:
    """`topic_sum` in PyTorch: the f32 sum of the per-topic deviations
    `values` (at least one) in XLA:CPU's order, on their device."""
    t = values.shape[0]
    if t > 32 or t == 1:
        return xla_order_sum(values)
    lanes = TOPIC_LANES[num_brokers > 32][t - 1]
    acc = values.new_zeros(max(lanes, 1))
    main = t - t % lanes if lanes else 0
    for i in range(main):
        acc[i % lanes] += values[i]
    # cclint: disable=cuda-shape-branch -- the plain version's summation order (XLA's), the CPU spec of the kernel; the card runs the kernel
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = acc[:h] + acc[h:]
    s = acc[0]
    for i in range(main, t):
        s = s + values[i]
    return s


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The f32 square root, correctly rounded (torch's f32 sqrt on the CPU is
    not always; the f64 one rounded to f32 is)."""
    return torch.sqrt(x.double()).float()


def _masked_stats(values: torch.Tensor, mask: torch.Tensor, n: torch.Tensor):
    """(mean, std, min, max) of `values` where `mask`, as f32 scalars
    (stats.py _masked_stats); `n` is max(mask count, 1)."""
    v = values.to(torch.float32)
    zero = v.new_zeros(())
    inf = v.new_full((), float("inf"))
    mean = xla_order_sum(torch.where(mask, v, zero)) / n
    d = v - mean
    var = xla_order_sum(torch.where(mask, d * d, zero)) / n
    return mean, _sqrt(var), torch.where(mask, v, inf).amin(), torch.where(mask, v, -inf).amax()


def cluster_stats_plain(broker_load, capacity, alive, replica_count, leader_count,
                        potential_nw_out, topic_replica_count):
    """(f32[25], i32[3]) on the inputs' device: see the module docstring."""
    load, cap, reps, leads, tc = (t.detach() for t in (broker_load, capacity, replica_count,
                                                       leader_count, topic_replica_count))
    f32 = torch.float32
    n = torch.clamp_min(alive.sum().to(f32), 1.0)
    util = load / torch.clamp_min(cap, 1e-9)
    res = [_masked_stats(util[:, r], alive, n) for r in range(4)]
    r_mean, r_std, r_min, r_max = _masked_stats(reps, alive, n)
    l_mean, l_std, _, _ = _masked_stats(leads, alive, n)
    p_mean, _, _, p_max = _masked_stats(potential_nw_out.detach(), alive, n)
    # per-topic spread (stats.py :93-100); integer count sums are exact
    counts = tc.to(f32)
    t_mean = (tc.long() * alive[None, :]).sum(dim=1).to(f32) / n
    d = counts - t_mean[:, None]
    t_var = xla_order_sum(torch.where(alive[None, :], d * d, counts.new_zeros(())).T) / n
    t_nonempty = tc.long().sum(dim=1) > 0
    t_std = torch.where(t_nonempty, _sqrt(t_var), counts.new_zeros(()))
    n_topics = torch.clamp_min(t_nonempty.sum().to(f32), 1.0)
    # cclint: disable=cuda-shape-branch -- the plain version's summation order (XLA's), the CPU spec of the kernel; the card runs the kernel
    topic_std = (topic_order_sum(t_std, load.shape[0]) / n_topics if t_std.shape[0]
                 else counts.new_zeros(()))
    out = torch.stack([*(x[0] for x in res), *(x[1] for x in res), *(x[2] for x in res),
                       *(x[3] for x in res), r_mean, r_std, r_min, r_max, l_mean, l_std,
                       topic_std, p_mean, p_max])
    out_i = torch.stack([alive.sum(), reps.long().sum(), leads.long().sum()]).to(torch.int32)
    return out, out_i


def _scratch(dev: int, t: int):
    """(topic deviations f32, counters i32[2] at 0, their addresses) of device
    `dev`, the deviations grown to at least `t`."""
    ws = _SCRATCH.get(dev)
    # cclint: disable=cuda-shape-branch -- the workspace grows once to the largest size seen; the launches are the same either way
    if ws is None or ws[0].numel() < t:
        cuda = torch.device("cuda", dev)
        std = torch.empty(max(t, 4096 if ws is None else 2 * ws[0].numel()),
                          dtype=torch.float32, device=cuda)
        counters = torch.zeros(2, dtype=torch.int32, device=cuda) if ws is None else ws[1]
        ws = _SCRATCH[dev] = (std, counters, std.data_ptr(), counters.data_ptr())
    return ws


def cluster_stats(broker_load, capacity, alive, replica_count, leader_count, potential_nw_out,
                  topic_replica_count):
    """`cluster_stats_plain` for CPU tensors, the CUDA kernel (one launch, any
    B and T) for CUDA ones; returns (f32[25], i32[3]) on the inputs' device."""
    if broker_load.device.type == "cpu":
        return cluster_stats_plain(broker_load, capacity, alive, replica_count, leader_count,
                                   potential_nw_out, topic_replica_count)
    dev = broker_load.device
    b = broker_load.shape[0]
    t = topic_replica_count.shape[0]
    for x, dtype, shape, name in ((broker_load, torch.float32, (b, 4), "broker_load"),
                                  (capacity, torch.float32, (b, 4), "capacity"),
                                  (alive, torch.bool, (b,), "alive"),
                                  (replica_count, torch.int32, (b,), "replica_count"),
                                  (leader_count, torch.int32, (b,), "leader_count"),
                                  (potential_nw_out, torch.float32, (b,), "potential_nw_out"),
                                  (topic_replica_count, torch.int32, (t, b),
                                   "topic_replica_count")):
        build.require(x, dtype, len(shape), name, dev)
        if tuple(x.shape) != shape:
            raise ValueError(f"cluster_stats: {name} has shape {tuple(x.shape)}, expected {shape}")
    ws = _scratch(dev.index, t)
    out = torch.empty(NUM_F32, dtype=torch.float32, device=dev)
    out_i = torch.empty(len(INT_SLOTS), dtype=torch.int32, device=dev)
    code = build.entry("cluster_stats", _ARGTYPES)(
        broker_load.data_ptr(), capacity.data_ptr(), alive.data_ptr(), replica_count.data_ptr(),
        leader_count.data_ptr(), potential_nw_out.data_ptr(), topic_replica_count.data_ptr(),
        ws[2], ws[3], out.data_ptr(), out_i.data_ptr(), b, t,
        TOPIC_LANES[b > 32][t - 1] if 1 < t <= 32 else -1, build.raw_stream(dev.index))
    if code:
        build.check(build.load("cluster_stats"), code, "cluster_stats")
    cluster_stats.launches += 1
    return out, out_i


cluster_stats.launches = 0
