"""Clean fixture: the same math kept on the device."""


def _kernel(x):
    return x * x.sum() + 1


def _build(device):
    import torch

    return dict(fn=_kernel, args=(torch.ones(4, device=device),))


CCLINT_TRACE_ENTRYPOINTS = [
    dict(name="device-only-kernel", build=_build),
]
