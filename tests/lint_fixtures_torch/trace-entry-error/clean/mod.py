"""Clean fixture: a well-formed registry whose entry builds and runs."""


def _kernel(x):
    return x + 1


def _build(device):
    import torch

    return dict(fn=_kernel, args=(torch.ones(4, device=device),))


CCLINT_TRACE_ENTRYPOINTS = [
    dict(name="healthy-entry", build=_build),
]
