"""Stream telemetry of the port: the in-step scalar monitor and the keyed
DynArray monitor."""

from . import monitor

__all__ = ["monitor"]
