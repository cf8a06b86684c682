"""Flag fixture: a 1 MiB tensor held by the entry's closure."""


def _build(device):
    import torch

    table = torch.zeros(1 << 18, device=device)  # 1 MiB of float32

    def _kernel(x):
        return x + table[:4]

    return dict(fn=_kernel, args=(torch.ones(4, device=device),))


CCLINT_TRACE_ENTRYPOINTS = [
    dict(name="held-table-kernel", build=_build),
]
