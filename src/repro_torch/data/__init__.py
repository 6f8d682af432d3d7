"""Synthetic stream generators of the port (numpy only)."""

from . import synthetic

__all__ = ["synthetic"]
