"""K8: the cluster statistics of a model, from the segment helpers' outputs.

Replaces cruise_control_tpu/analyzer/stats.py compute_stats (:69) with
_masked_stats (:58): masked mean / std / min / max over the alive brokers of
each resource's utilisation, the replica and leader counts and the potential
NW_OUT, plus the mean over the non-empty topics of each topic's replica-count
standard deviation across the alive brokers. The CUDA kernel is
csrc/cluster_stats.cu; `cluster_stats_plain` is the numpy version. Every
float sum of both is taken in XLA:CPU's order (kernels/window_sum.py), so
both are bit-equal to the jitted reference.

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
from cruise_control_torch.kernels.window_sum import xla_sum

#: (field, width) of the packed f32 output, in ClusterModelStats order
STAT_SLOTS = (("resource_mean", 4), ("resource_std", 4), ("resource_min", 4),
              ("resource_max", 4), ("replica_mean", 1), ("replica_std", 1),
              ("replica_min", 1), ("replica_max", 1), ("leader_mean", 1), ("leader_std", 1),
              ("topic_replica_std", 1), ("potential_nw_out_mean", 1),
              ("potential_nw_out_max", 1))
NUM_F32 = sum(w for _, w in STAT_SLOTS)
INT_SLOTS = ("num_alive_brokers", "num_replicas", "num_leaders")

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
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = acc[:h] + acc[h:]
    s = acc[0]
    for i in range(main, t):
        s = _F(s + values[i])
    return _F(s)


def _masked_stats(values: np.ndarray, mask: np.ndarray, n: np.float32):
    """(mean, std, min, max) of `values` where `mask`, as float32 scalars
    (stats.py _masked_stats); `n` is max(mask count, 1)."""
    v = values.astype(_F)
    zero = _F(0.0)
    mean = _F(xla_sum(np.where(mask, v, zero)) / n)
    d = v - mean
    var = _F(xla_sum(np.where(mask, d * d, zero)) / n)
    vmin = np.where(mask, v, _F(np.inf)).min()
    vmax = np.where(mask, v, _F(-np.inf)).max()
    return mean, np.sqrt(var), _F(vmin), _F(vmax)


def cluster_stats_plain(broker_load, capacity, alive, replica_count, leader_count,
                        potential_nw_out, topic_replica_count):
    """(f32[25], i32[3]) on the CPU: see the module docstring."""
    load, cap, alive_m, reps, leads, pnw, tc = (
        t.detach().cpu().numpy() for t in (broker_load, capacity, alive, replica_count,
                                           leader_count, potential_nw_out, topic_replica_count))
    n = np.maximum(_F(alive_m.sum()), _F(1.0))
    util = load / np.maximum(cap, _F(1e-9))
    res = [_masked_stats(util[:, r], alive_m, n) for r in range(4)]
    r_mean, r_std, r_min, r_max = _masked_stats(reps, alive_m, n)
    l_mean, l_std, _, _ = _masked_stats(leads, alive_m, n)
    p_mean, _, _, p_max = _masked_stats(pnw, alive_m, n)
    # per-topic spread (stats.py :93-100); integer count sums are exact
    counts = tc.astype(_F)
    t_mean = (tc.astype(np.int64) * alive_m[None, :]).sum(axis=1).astype(_F) / n
    d = counts - t_mean[:, None]
    t_var = xla_sum(np.where(alive_m[None, :], d * d, _F(0.0)).T) / n
    t_nonempty = tc.astype(np.int64).sum(axis=1) > 0
    t_std = np.where(t_nonempty, np.sqrt(t_var), _F(0.0)).astype(_F)
    n_topics = np.maximum(_F(t_nonempty.sum()), _F(1.0))
    topic_std = _F(topic_sum(t_std, load.shape[0]) / n_topics) if t_std.shape[0] else _F(0.0)
    out = np.array([*(x[0] for x in res), *(x[1] for x in res), *(x[2] for x in res),
                    *(x[3] for x in res), r_mean, r_std, r_min, r_max, l_mean, l_std, topic_std,
                    p_mean, p_max], dtype=_F)
    out_i = np.array([alive_m.sum(), reps.astype(np.int64).sum(), leads.astype(np.int64).sum()],
                     dtype=np.int32)
    return torch.from_numpy(out), torch.from_numpy(out_i)


def cluster_stats(broker_load, capacity, alive, replica_count, leader_count, potential_nw_out,
                  topic_replica_count):
    """`cluster_stats_plain` for CPU tensors, the CUDA kernel (two launches)
    for CUDA ones; returns (f32[25], i32[3]) on the inputs' device."""
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
    if (max(b, t) + 31) // 32 * 4 > 36 * 1024:
        raise ValueError(f"cluster_stats: {b} brokers / {t} topics exceed the kernel's shared memory")
    topic_std = torch.empty(t, dtype=torch.float32, device=dev)
    topic_nonempty = torch.empty(t, dtype=torch.int32, device=dev)
    out = torch.empty(NUM_F32, dtype=torch.float32, device=dev)
    out_i = torch.empty(len(INT_SLOTS), dtype=torch.int32, device=dev)
    lib = build.load("cluster_stats")
    code = lib.cluster_stats(
        build.ptrs(broker_load, capacity, alive, replica_count, leader_count, potential_nw_out,
                   topic_replica_count, topic_std, topic_nonempty, out, out_i),
        build.ints(b, t, TOPIC_LANES[b > 32][t - 1] if 1 < t <= 32 else -1), build.stream())
    build.check(lib, code, "cluster_stats")
    cluster_stats.launches += 1
    return out, out_i


cluster_stats.launches = 0
