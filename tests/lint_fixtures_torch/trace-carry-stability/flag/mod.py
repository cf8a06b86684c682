"""Flag fixture: a float64 op, and a round whose carried state grows each
run (a captured round could not replay it)."""


def _double(x):
    return (x.double() * 3).float()


def _growing_round(x):
    import torch

    return torch.cat([x, x])


def _build_double(device):
    import torch

    return dict(fn=_double, args=(torch.ones(4, device=device),))


def _build_growing(device):
    import torch

    return dict(fn=_growing_round, args=(torch.ones(4, device=device),), carry=((0, 0),))


CCLINT_TRACE_ENTRYPOINTS = [
    dict(name="float64-kernel", build=_build_double),
    dict(name="growing-carry-round", build=_build_growing),
]
