"""Hand-written CUDA kernels of the proposal path, each beside its plain
PyTorch version.

  K1 segment_aggregates  context.compute_aggregates
  K2 broker_topk         drain.broker_top_replicas
  K3 score_candidates    acceptance.score_batch + actions.build_selected
  K4 apply_wave          context.wave_select + context.apply_actions_batch

A wrapper runs the plain version for CPU tensors and launches its kernel for
CUDA tensors (or raises); it counts its launches in `<wrapper>.launches`.
Sources are in `cruise_control_torch/csrc/`, built by `kernels.build` at
first use.
"""

from __future__ import annotations


def wrappers():
    """{name: wrapper} of the four kernels (imported on demand: the K3 module
    imports the analyzer)."""
    from cruise_control_torch.kernels.apply_wave import apply_wave
    from cruise_control_torch.kernels.broker_topk import broker_topk
    from cruise_control_torch.kernels.score_candidates import score_candidates
    from cruise_control_torch.kernels.segment_aggregates import segment_aggregates

    return {
        "segment_aggregates": segment_aggregates,
        "broker_topk": broker_topk,
        "score_candidates": score_candidates,
        "apply_wave": apply_wave,
    }


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}
