"""Not a kernel module: host copies are this layer's job."""


def render(t):
    return float(t.max().item()), t.cpu().tolist()
