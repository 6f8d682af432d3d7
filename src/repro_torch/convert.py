"""Carry sketch state between the JAX package and the port.

``from_jax_numpy(state, device)`` takes one of the JAX package's state
NamedTuples — ``QSketchState``, ``DynState``, ``DynArrayState``,
``SketchArrayState``, ``WindowArrayState``, ``FloatSketchState``,
``VirtualDynArrayState``, ``DirectoryState``, ``MonitorState``,
``ArrayMonitorState``, ``DynArrayMonitorState``, ``WindowMonitorState``,
``VirtualDynMonitorState`` or ``AnomalyBankState`` — with
numpy (or array-like) leaves, and returns the port's NamedTuple of the same
name with tensors on ``device``. ``to_numpy(state)`` goes back: the port's
NamedTuple with numpy leaves in the JAX package's dtypes, ready for
``JaxType(*(jnp.asarray(x) for x in leaves))``. The state type is matched
by class name and fields, so neither package imports the other.

Dtypes carry over unchanged, except the directory's uint32 fingerprints,
which the port holds as int64 (``core/key_directory.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.key_directory import DirectoryState
from .core.types import (
    DynArrayState, DynState, FloatSketchState, QSketchState, SketchArrayState,
    VirtualDynArrayState, WindowArrayState, resolve_device,
)
from .sketchstream.anomaly import AnomalyBankState
from .sketchstream.monitor import (
    ArrayMonitorState, DynArrayMonitorState, MonitorState, VirtualDynMonitorState,
    WindowMonitorState,
)

STATE_TYPES = {
    cls.__name__: cls
    for cls in (
        QSketchState, DynState, DynArrayState, SketchArrayState, WindowArrayState,
        FloatSketchState, VirtualDynArrayState, DirectoryState, MonitorState,
        ArrayMonitorState, DynArrayMonitorState, WindowMonitorState,
        VirtualDynMonitorState, AnomalyBankState,
    )
}
_UINT32_FIELDS = {("DirectoryState", "fingerprints")}


def _port_type(state):
    cls = STATE_TYPES.get(type(state).__name__)
    if cls is None or tuple(getattr(state, "_fields", ())) != cls._fields:
        raise TypeError(f"not a convertible sketch state: {type(state).__name__}")
    return cls


def from_jax_numpy(state, device="cuda"):
    """The port's state of the same type, tensors on ``device``."""
    cls = _port_type(state)
    dev = resolve_device(device)
    leaves = []
    for name, leaf in zip(cls._fields, state):
        if isinstance(leaf, tuple):
            leaves.append(from_jax_numpy(leaf, dev))
            continue
        arr = np.asarray(leaf)
        if (cls.__name__, name) in _UINT32_FIELDS:
            arr = arr.astype(np.uint32).astype(np.int64)
        leaves.append(torch.from_numpy(np.array(arr, copy=True)).to(dev))
    return cls(*leaves)


def to_numpy(state):
    """The port's state with numpy leaves (copies) in the JAX package's dtypes."""
    cls = _port_type(state)
    leaves = []
    for name, leaf in zip(cls._fields, state):
        if isinstance(leaf, tuple):
            leaves.append(to_numpy(leaf))
            continue
        arr = leaf.detach().cpu().numpy().copy()  # never a view of the port's tensor
        if (cls.__name__, name) in _UINT32_FIELDS:
            arr = arr.astype(np.uint32)
        leaves.append(arr)
    return cls(*leaves)
