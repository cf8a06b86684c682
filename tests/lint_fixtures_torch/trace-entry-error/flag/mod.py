"""Flag fixture: a registry whose build raises — a surface no trace rule can
certify is itself a finding, not a silent skip."""


def _build(device):
    raise RuntimeError("broken registry entry: model generator unavailable")


CCLINT_TRACE_ENTRYPOINTS = [
    dict(name="broken-entry", build=_build),
]
