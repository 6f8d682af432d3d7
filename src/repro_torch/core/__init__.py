"""Core sketch library of the port.

    cfg   = SketchConfig(m=256, b=8, seed=1)
    state = qsketch.init(cfg)                          # on "cuda"
    state = qsketch.update(cfg, state, ids, weights)   # batched, exact (K1)
    chat  = qsketch.estimate(cfg, state)               # MLE (Newton)

    dyn   = qsketch_dyn.init(cfg)
    dyn   = qsketch_dyn.update_batch(cfg, dyn, ids, weights)   # q_R in K2
    chat  = qsketch_dyn.estimate(dyn)                  # anytime, O(0)

Pass ``device="cpu"`` to ``init`` to run the plain PyTorch path.
"""

from . import (
    dyn_array,
    estimation,
    estimators,
    hashing,
    key_directory,
    qsketch,
    qsketch_dyn,
    sketch_array,
    window_array,
)
from .key_directory import DirectoryConfig, DirectoryState
from .types import (
    DynArrayState,
    DynState,
    QSketchState,
    SketchArrayState,
    SketchConfig,
    WindowArrayState,
    resolve_device,
)

__all__ = [
    "SketchConfig",
    "QSketchState",
    "DirectoryConfig",
    "DirectoryState",
    "DynArrayState",
    "DynState",
    "SketchArrayState",
    "WindowArrayState",
    "resolve_device",
    "qsketch",
    "qsketch_dyn",
    "dyn_array",
    "sketch_array",
    "window_array",
    "key_directory",
    "estimation",
    "estimators",
    "hashing",
]
