"""Hand-written CUDA kernels of the proposal path, each beside its plain
PyTorch version.

  K1 segment_aggregates  context.compute_aggregates
  K2 broker_topk         drain.broker_top_replicas
  K3 score_candidates    acceptance.score_batch + actions.build_selected
  K4 apply_wave          context.wave_select + context.apply_actions_batch
  K5 score_swaps         the swap / topic-swap / relay validations
                         (acceptance.swap_tables_acceptance)
  K6 pair_picks          drain.pair_replica_picks
  window_sum             the soft goals' sequential window sums

A wrapper runs the plain version for CPU tensors and launches its kernel for
CUDA tensors (or raises); it counts its launches in `<wrapper>.launches`.
Sources are in `cruise_control_torch/csrc/`, built by `kernels.build` at
first use.
"""

from __future__ import annotations


def wrappers():
    """{name: wrapper} of the kernels (imported on demand: the K3 module
    imports the analyzer)."""
    from cruise_control_torch.kernels.apply_wave import apply_wave
    from cruise_control_torch.kernels.broker_topk import broker_topk
    from cruise_control_torch.kernels.pair_picks import pair_picks
    from cruise_control_torch.kernels.score_candidates import score_candidates
    from cruise_control_torch.kernels.score_swaps import score_swaps
    from cruise_control_torch.kernels.segment_aggregates import segment_aggregates
    from cruise_control_torch.kernels.window_sum import window_sum

    return {
        "segment_aggregates": segment_aggregates,
        "broker_topk": broker_topk,
        "score_candidates": score_candidates,
        "apply_wave": apply_wave,
        "score_swaps": score_swaps,
        "pair_picks": pair_picks,
        "window_sum": window_sum,
    }


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}
