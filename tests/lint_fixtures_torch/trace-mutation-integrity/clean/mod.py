"""Clean fixture: the one argument written in place is declared."""


def _kernel(x, y):
    x.add_(y)
    return x


def _build(device):
    import torch

    return dict(fn=_kernel, args=(torch.ones(4, device=device), torch.ones(4, device=device)),
                mutates_argnums=(0,))


CCLINT_TRACE_ENTRYPOINTS = [
    dict(name="declared-write-kernel", build=_build),
]
