"""Core sketch library of the port.

    cfg   = SketchConfig(m=256, b=8, seed=1)
    state = qsketch.init(cfg)                          # on "cuda"
    state = qsketch.update(cfg, state, ids, weights)   # batched, exact (K1)
    chat  = qsketch.estimate(cfg, state)               # MLE (Newton)

    dyn   = qsketch_dyn.init(cfg)
    dyn   = qsketch_dyn.update_batch(cfg, dyn, ids, weights)   # q_R in K2
    chat  = qsketch_dyn.estimate(dyn)                  # anytime, O(0)

Baselines (LM / FastGM / FastExpSketch) live in ``baselines``; the uniform
``METHODS`` registry below drives the paper's five-method comparison.

Pass ``device="cpu"`` to ``init`` to run the plain PyTorch path.
"""

from . import (
    baselines,
    dyn_array,
    estimation,
    estimators,
    hashing,
    key_directory,
    qsketch,
    qsketch_dyn,
    sketch_array,
    virtual_dyn_array,
    window_array,
)
from .key_directory import DirectoryConfig, DirectoryState
from .types import (
    DynArrayState,
    DynState,
    FloatSketchState,
    QSketchState,
    SketchArrayState,
    SketchConfig,
    VirtualDynArrayState,
    WindowArrayState,
    resolve_device,
)
from .virtual_dyn_array import VirtualConfig

# Uniform method registry: name -> the standard operations. Signatures, as
# in the JAX package: init(cfg) (here init(cfg, device="cuda")); update(cfg,
# state, ids, weights, mask=None); estimate(cfg, state); merge(cfg, a, b).
# register_bits None means cfg.b.
METHODS = {
    "LM": dict(
        init=baselines.init,
        update=baselines.lm_update,
        estimate=lambda cfg, s: baselines.estimate(s),
        merge=lambda cfg, a, b: baselines.merge(a, b),
        register_bits=32,
    ),
    "FastGM": dict(
        init=baselines.init,
        update=baselines.fastgm_update,
        estimate=lambda cfg, s: baselines.estimate(s),
        merge=lambda cfg, a, b: baselines.merge(a, b),
        register_bits=32,
    ),
    "FastExpSketch": dict(
        init=baselines.init,
        update=baselines.fastexp_update,
        estimate=lambda cfg, s: baselines.estimate(s),
        merge=lambda cfg, a, b: baselines.merge(a, b),
        register_bits=32,
    ),
    "QSketch": dict(
        init=qsketch.init,
        update=qsketch.update,
        estimate=qsketch.estimate,
        merge=lambda cfg, a, b: qsketch.merge(a, b),
        register_bits=None,
    ),
    "QSketch-Dyn": dict(
        init=qsketch_dyn.init,
        update=qsketch_dyn.update_batch,
        estimate=lambda cfg, s: qsketch_dyn.estimate(s),
        merge=qsketch_dyn.merge,
        register_bits=None,
    ),
}

__all__ = [
    "METHODS",
    "SketchConfig",
    "FloatSketchState",
    "VirtualConfig",
    "VirtualDynArrayState",
    "QSketchState",
    "DirectoryConfig",
    "DirectoryState",
    "DynArrayState",
    "DynState",
    "SketchArrayState",
    "WindowArrayState",
    "resolve_device",
    "baselines",
    "qsketch",
    "qsketch_dyn",
    "virtual_dyn_array",
    "dyn_array",
    "sketch_array",
    "window_array",
    "key_directory",
    "estimation",
    "estimators",
    "hashing",
]
