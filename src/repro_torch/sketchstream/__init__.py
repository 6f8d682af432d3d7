"""Stream telemetry of the port: the in-step scalar monitor, the per-key
SketchArray monitor, the keyed DynArray monitor, the sliding-window
monitor and its AnomalyBank."""

from . import anomaly, monitor

__all__ = ["anomaly", "monitor"]
