"""Flag fixture: a scalar read buried in the entry — the host waits for the
card before the next launch (no `.item()` at the call site to see)."""


def _scale(x):
    return x * x.sum().item()


def _kernel(x):
    return _scale(x) + 1


def _build(device):
    import torch

    return dict(fn=_kernel, args=(torch.ones(4, device=device),))


CCLINT_TRACE_ENTRYPOINTS = [
    dict(name="scalar-read-kernel", build=_build),
]
