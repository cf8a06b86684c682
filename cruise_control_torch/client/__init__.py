"""Python REST client + CLI (the cruise-control-client analog)."""

from cruise_control_torch.client.cccli import CruiseControlClient, main

__all__ = ["CruiseControlClient", "main"]
