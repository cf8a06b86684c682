"""Clean fixture: a float32 round whose carried state keeps its dtype,
shape and device."""


def _round(x):
    return x * 3 + 1


def _build(device):
    import torch

    return dict(fn=_round, args=(torch.ones(4, device=device),), carry=((0, 0),))


CCLINT_TRACE_ENTRYPOINTS = [
    dict(name="stable-carry-round", build=_build),
]
