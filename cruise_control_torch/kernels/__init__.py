"""Hand-written CUDA kernels of the proposal path, each beside its plain
PyTorch version.

  K1 segment_aggregates  context.compute_aggregates
  K2 broker_topk         drain.broker_top_replicas
  K3 score_candidates    acceptance.score_batch + actions.build_selected
  K4 apply_wave          context.wave_select + context.apply_actions_batch
  K5 score_swaps         the swap / topic-swap / relay validations
                         (acceptance.swap_tables_acceptance)
  K6 pair_picks          drain.pair_replica_picks
  window_sum             float32 sums in XLA:CPU's order (the goals' windows
                         and costs)
  K7 state_fingerprint   optimizer._state_fingerprint
  K8 cluster_stats       stats.compute_stats
  K9 grid_shortlist      the greedy round's shortlist (optimizer.one_round
                         :371-409), scoring with K3's per-candidate body
  K10 delta_scatter      incremental.apply_delta_batch, the incremental
                         lane's scatter into the static context
  K11 elect_preferred    goals/preferred.elect_preferred_leaders, the
                         preferred-leader election off demoted and dead
                         brokers
  K12 shard_merge        the partition-axis mesh's merge of the shards'
                         shortlist records, their global rows included
                         (parallel/spmd.make_grid_shortlist :170-171,
                         :185-189)
  K13 partition_stats    a shard's coverage counts
                         (parallel/spmd.make_partition_stats :218-227)

A wrapper runs the plain version for CPU tensors and launches its kernel for
CUDA tensors (or raises); it counts its launches in `<wrapper>.launches`
(K3 also by goal case and by path, in `score_candidates.cases` and `.paths`,
K5 by path in `score_swaps.paths`).
Sources are in `cruise_control_torch/csrc/`, built by `kernels.build` at
first use.
"""

from __future__ import annotations


def wrappers():
    """{name: wrapper} of the kernels (imported on demand: the K3 module
    imports the analyzer)."""
    from cruise_control_torch.kernels.apply_wave import apply_wave
    from cruise_control_torch.kernels.broker_topk import broker_topk
    from cruise_control_torch.kernels.cluster_stats import cluster_stats
    from cruise_control_torch.kernels.delta_scatter import delta_scatter
    from cruise_control_torch.kernels.elect_preferred import elect_preferred
    from cruise_control_torch.kernels.grid_shortlist import grid_shortlist
    from cruise_control_torch.kernels.pair_picks import pair_picks
    from cruise_control_torch.kernels.partition_stats import partition_stats
    from cruise_control_torch.kernels.score_candidates import score_candidates
    from cruise_control_torch.kernels.score_swaps import score_swaps
    from cruise_control_torch.kernels.segment_aggregates import segment_aggregates
    from cruise_control_torch.kernels.shard_merge import shard_merge
    from cruise_control_torch.kernels.state_fingerprint import state_fingerprint
    from cruise_control_torch.kernels.window_sum import window_sum

    return {
        "segment_aggregates": segment_aggregates,
        "broker_topk": broker_topk,
        "score_candidates": score_candidates,
        "apply_wave": apply_wave,
        "score_swaps": score_swaps,
        "pair_picks": pair_picks,
        "window_sum": window_sum,
        "state_fingerprint": state_fingerprint,
        "cluster_stats": cluster_stats,
        "grid_shortlist": grid_shortlist,
        "delta_scatter": delta_scatter,
        "elect_preferred": elect_preferred,
        "shard_merge": shard_merge,
        "partition_stats": partition_stats,
    }


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        for counter in ("cases", "paths"):
            if hasattr(fn, counter):
                getattr(fn, counter).clear()


def launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}
