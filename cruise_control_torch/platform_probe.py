"""The CUDA probe: a card that is dead, missing or hanging is an error.

The JAX package's platform_probe.py probes the default backend in a
subprocess and, when the probe hangs or fails, pins the CPU and carries on
(`fallback=True`). The port does not fall back. The device is the card
unless the caller asks for the CPU explicitly (`device="cpu"`, as the tests
do); a card that does not answer raises `DeviceUnavailableError`, which
names the card, and nothing degrades to the CPU.

`ensure_live_backend(device="cuda")` runs `torch.cuda` initialisation and a
one-element allocation on the card in a subprocess under a timeout, so a
hanging driver can be killed before this process touches the card. The
verdict keeps the JAX package's `ProbeResult` fields, so the telemetry
fingerprint's schema is the same; its `fallback` is always False.
"""

from __future__ import annotations

import subprocess
import sys
from typing import NamedTuple, Optional

#: what the probe subprocess runs: CUDA initialisation, one element on the
#: card, a synchronize, then the card's name on the last line
_PROBE = (
    "import sys, torch\n"
    "dev = torch.device(sys.argv[1])\n"
    "if not torch.cuda.is_available():\n"
    "    raise SystemExit('torch.cuda.is_available() is False')\n"
    "torch.cuda.init()\n"
    "torch.zeros(1, device=dev).add_(1)\n"
    "torch.cuda.synchronize(dev)\n"
    "print(torch.cuda.get_device_name(dev))\n"
)


class DeviceUnavailableError(RuntimeError):
    """The card the caller asked for did not answer the probe."""


class ProbeResult(NamedTuple):
    """Outcome of ensure_live_backend (the JAX package's fields)."""

    platform: str  # "gpu" for the card, "cpu" when the caller asked for it
    fallback: bool  # always False: the port never falls back to the CPU
    attempts: int  # subprocess probes performed (0 for the CPU, else 1)


def probe_card(timeout_s: float, device: str) -> tuple[Optional[str], str]:
    """(the card's name, "") when `device` initialises and holds one element
    within `timeout_s`, else (None, why). Runs in a subprocess, so a hanging
    driver can be killed; this process does not touch the card."""
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE, device], capture_output=True,
                             text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None, f"no answer within {timeout_s:.0f} s"
    if out.returncode != 0:
        lines = (out.stderr or out.stdout).strip().splitlines()
        return None, lines[-1] if lines else f"exit code {out.returncode}"
    name = out.stdout.strip().splitlines()
    return (name[-1], "") if name else (None, "the probe printed no device name")


def ensure_live_backend(timeout_s: float = 75.0, log=None, device: str = "cuda") -> ProbeResult:
    """Check that `device` answers before this process touches it; return the
    verdict. `device="cpu"` is the caller's explicit choice and is not
    probed. A card that does not answer raises DeviceUnavailableError, which
    names it and the reason."""
    if log is None:
        def log(msg):  # pragma: no cover - trivial default
            print(msg, file=sys.stderr, flush=True)

    if device == "cpu":
        log("platform: cpu (asked for by the caller)")
        return _record(ProbeResult(platform="cpu", fallback=False, attempts=0), device)
    if not device.startswith("cuda"):
        raise ValueError(f"device must be 'cpu' or a CUDA device, got {device!r}")
    card = device if ":" in device else f"{device}:0"
    log(f"probing {card} (subprocess, {timeout_s:.0f}s timeout)...")
    name, why = probe_card(timeout_s, device)
    if name is None:
        raise DeviceUnavailableError(
            f"CUDA device {card} is not usable ({why}); the port does not fall back to the "
            "CPU: pass --device cpu (device='cpu') to run there")
    log(f"platform: {card} live -> {name}")
    return _record(ProbeResult(platform="gpu", fallback=False, attempts=1), device)


def _record(result: ProbeResult, device: str) -> ProbeResult:
    """Stamp the verdict and the device into the telemetry collector."""
    from cruise_control_torch.common.telemetry import TELEMETRY

    TELEMETRY.set_probe_fallback(result.fallback)
    TELEMETRY.configure(device=device)
    return result
