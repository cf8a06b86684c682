"""Flag fixture: an argument written in place that the call site does not
declare, and a declared one nothing writes."""


def _undeclared(x, y):
    y.add_(1)
    return x + y


def _unwritten(x):
    return x + 1


def _build_undeclared(device):
    import torch

    return dict(fn=_undeclared, args=(torch.ones(4, device=device), torch.ones(4, device=device)))


def _build_unwritten(device):
    import torch

    return dict(fn=_unwritten, args=(torch.ones(4, device=device),), mutates_argnums=(0,))


CCLINT_TRACE_ENTRYPOINTS = [
    dict(name="undeclared-write-kernel", build=_build_undeclared),
    dict(name="stale-declaration-kernel", build=_build_unwritten),
]
