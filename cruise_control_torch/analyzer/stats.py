"""Cluster model statistics (the JAX package's analyzer/stats.py).

The analog of ClusterModelStats (cc/model/ClusterModelStats.java:22): per-
resource utilisation mean / standard deviation / min / max over the alive
brokers, replica and leader count statistics, the per-topic replica spread
and potential NW_OUT. `compute_stats` takes the segment helpers' sums of the
model's own assignment (K1) and reduces them with K8
(kernels.cluster_stats), whose float sums follow XLA:CPU's order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cruise_control_torch.common.resources import Resource
from cruise_control_torch.kernels.cluster_stats import INT_SLOTS, STAT_SLOTS, cluster_stats
from cruise_control_torch.models.flat_model import FlatClusterModel, alive_broker_mask, segment_sums


class ClusterModelStats(NamedTuple):
    """Per-cluster summary statistics over the alive brokers (fields and
    order as the JAX package's)."""

    # f32[4] each, indexed by Resource
    resource_mean: torch.Tensor
    resource_std: torch.Tensor
    resource_min: torch.Tensor
    resource_max: torch.Tensor
    # replica count stats, f32[] each
    replica_mean: torch.Tensor
    replica_std: torch.Tensor
    replica_min: torch.Tensor
    replica_max: torch.Tensor
    # leader replica count stats
    leader_mean: torch.Tensor
    leader_std: torch.Tensor
    # topic-replica spread: mean over topics of per-topic stddev across brokers
    topic_replica_std: torch.Tensor
    # potential nw out stats
    potential_nw_out_mean: torch.Tensor
    potential_nw_out_max: torch.Tensor
    num_alive_brokers: torch.Tensor
    num_replicas: torch.Tensor
    num_leaders: torch.Tensor


def _unpack(out, out_i) -> ClusterModelStats:
    """The fields of K8's packed outputs (kernels.cluster_stats)."""
    fields, at = [], 0
    for _, width in STAT_SLOTS:
        fields.append(out[at:at + width] if width > 1 else out[at])
        at += width
    return ClusterModelStats(*fields, *(out_i[i] for i in range(len(INT_SLOTS))))


def compute_stats(model: FlatClusterModel, num_topics: int) -> ClusterModelStats:
    """The statistics of `model`, on its device (stats.py :69)."""
    load, replicas, leaders, pnw, _, _, topic_counts, _ = segment_sums(model, num_topics)
    return _unpack(*cluster_stats(load, model.broker_capacity, alive_broker_mask(model), replicas,
                                  leaders, pnw, topic_counts))


def stats_to_host(stats: ClusterModelStats) -> ClusterModelStats:
    """The same statistics as numpy values, in one transfer each for the
    float and the integer fields."""
    n = len(STAT_SLOTS)
    out = torch.cat([torch.atleast_1d(x) for x in stats[:n]]).cpu().numpy()
    return _unpack(out, torch.stack(list(stats[n:])).cpu().numpy())


def stats_to_dict(stats: ClusterModelStats) -> dict:
    """Host-side JSON-friendly rendering (servlet response stats analog)."""
    res_names = [r.name for r in Resource]
    return {
        "resources": {
            name: {
                "mean": float(np.asarray(stats.resource_mean)[i]),
                "std": float(np.asarray(stats.resource_std)[i]),
                "min": float(np.asarray(stats.resource_min)[i]),
                "max": float(np.asarray(stats.resource_max)[i]),
            }
            for i, name in enumerate(res_names)
        },
        "replicas": {
            "mean": float(stats.replica_mean),
            "std": float(stats.replica_std),
            "min": float(stats.replica_min),
            "max": float(stats.replica_max),
        },
        "leaderReplicas": {"mean": float(stats.leader_mean), "std": float(stats.leader_std)},
        "topicReplicasStd": float(stats.topic_replica_std),
        "potentialNwOut": {
            "mean": float(stats.potential_nw_out_mean),
            "max": float(stats.potential_nw_out_max),
        },
        "numAliveBrokers": int(stats.num_alive_brokers),
        "numReplicas": int(stats.num_replicas),
        "numLeaders": int(stats.num_leaders),
    }
