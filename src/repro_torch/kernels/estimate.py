"""K4 wrapper: fused per-row bincount + 30-step Newton (``csrc/estimate.cu``).

Replaces ``src/repro/kernels/estimate.py:_estimate_kernel``: the ``fused``
solver of ``core/estimation.py``. A CPU tensor takes the plain version
(``ref.estimate_rows_ref``); a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from ..core.types import SketchConfig
from . import _build, ref

N_ITERS = 30  # fixed Newton steps, as in the JAX kernel's _N_ITERS

KERNEL = _build.Kernel(
    "estimate", "estimate_launch",
    [_build.P, _build.LL, _build.I, _build.I, _build.I, _build.I, _build.P, _build.P, _build.P],
)


def estimate_rows(cfg: SketchConfig, regs):
    """Unscaled (chat f32[K], stddev f32[K], converged bool[K]) of int8[K, m] rows."""
    if regs.device.type == "cpu":
        return ref.estimate_rows_ref(cfg, regs)
    if regs.device.type != "cuda":
        raise ValueError(f"estimate: unsupported device {regs.device}")
    k = regs.shape[0]
    chat = torch.empty(k, dtype=torch.float32, device=regs.device)
    std = torch.empty_like(chat)
    conv = torch.empty(k, dtype=torch.int32, device=regs.device)
    if k:
        KERNEL(
            regs.device, regs.data_ptr(), k, cfg.m, cfg.num_bins, cfg.r_min,
            cfg.top_bin, chat.data_ptr(), std.data_ptr(), conv.data_ptr(),
        )
    return chat, std, conv > 0
