"""Clean fixture: one gather a call, its budget."""


def _shortlist(x):
    from cruise_control_torch.common.telemetry import TELEMETRY

    TELEMETRY.record_collective("all-gather", 64, "fixture", "fixture-shortlist", per_round=True)
    return x.max()


def _build(device):
    import torch

    return dict(fn=_shortlist, args=(torch.ones(8, device=device),),
                collectives={"all-gather": 1})


CCLINT_TRACE_ENTRYPOINTS = [
    dict(name="budgeted-mesh-kernel", build=_build),
]
