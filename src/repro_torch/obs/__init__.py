"""Observability of the port: the process-local metrics registry."""

from . import metrics

__all__ = ["metrics"]
