"""Process-local metrics registry: the gauge families the tenant monitors
publish to.

Every gauge is declared once, at module level, through ``gauge`` with a
literal snake_case name (DESIGN.md §10). Emitting through
``family.labels(monitor="dyn_array")`` memoizes one series per label-value
tuple, so several monitor instances share one declared name. Values are
host Python numbers: callers convert device scalars before emitting.

This is the part of ``repro/obs/metrics.py`` that the port's main path
publishes through; the port imports nothing of the JAX package. Counters,
histograms and snapshots come over with the slice that ports their users.
"""

from __future__ import annotations

import os


class Series:
    """One (family, label-values) gauge series: a last-write-wins value."""

    __slots__ = ("labels", "value")

    def __init__(self, labels: dict):
        self.labels = labels
        self.value = 0

    def set(self, v) -> None:
        """Gauge assignment (a no-op while the registry is disabled)."""
        if _ENABLED[0]:
            self.value = v


class Gauge:
    """One declared gauge family: name, help text, label names, series."""

    def __init__(self, name: str, help: str, label_names: tuple):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series: dict[tuple, Series] = {}

    def labels(self, **kv) -> Series:
        """The series for one label-value assignment (memoized). Every
        declared label name must be given; values are stringified."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(kv))}"
            )
        key = tuple(str(kv[n]) for n in self.label_names)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = Series(dict(zip(self.label_names, key)))
        return s


_ENABLED = [not os.environ.get("QOBS_DISABLED")]
_FAMILIES: dict[str, Gauge] = {}


def gauge(name: str, help: str = "", labels: tuple = ()) -> Gauge:
    """Declare (or fetch) a gauge family on the process registry."""
    fam = _FAMILIES.get(name)
    if fam is None:
        fam = _FAMILIES[name] = Gauge(name, help, labels)
    elif fam.label_names != tuple(labels):
        raise ValueError(f"metric {name!r} already declared with labels {fam.label_names}")
    return fam


def configure(*, enabled: bool) -> None:
    """Toggle the registry: while disabled, emissions are no-ops."""
    _ENABLED[0] = bool(enabled)


def enabled() -> bool:
    """Whether the registry records emissions."""
    return _ENABLED[0]
