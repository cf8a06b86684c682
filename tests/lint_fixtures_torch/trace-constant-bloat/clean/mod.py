"""Clean fixture: the big operand arrives as an argument."""


def _kernel(x, table):
    return x + table[:4]


def _build(device):
    import torch

    return dict(fn=_kernel, args=(torch.ones(4, device=device), torch.zeros(1 << 18, device=device)))


CCLINT_TRACE_ENTRYPOINTS = [
    dict(name="argument-table-kernel", build=_build),
]
