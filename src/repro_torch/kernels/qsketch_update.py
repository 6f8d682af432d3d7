"""K1 wrapper: the full-QSketch register update (``csrc/qsketch_update.cu``).

Replaces ``src/repro/kernels/qsketch_update.py:_qsketch_kernel``. A CPU
tensor takes the plain version (``ref.qsketch_update_ref``); a CUDA tensor
launches the kernel, which folds into an int32 copy of the registers with
``atomicMax`` (the wrapper converts back to int8).
"""

from __future__ import annotations

import torch

from . import _build, ref

KERNEL = _build.Kernel(
    "qsketch_update", "qsketch_update_launch",
    [_build.P, _build.P, _build.P, _build.LL, _build.I, _build.U, _build.I, _build.I, _build.P],
)


def update_regs(lo, hi, log2w, regs, *, salt: int, r_min: int, r_max: int):
    """int8[m] registers after folding the batch (see ``ref.qsketch_update_ref``)."""
    if regs.device.type == "cpu":
        return ref.qsketch_update_ref(lo, hi, log2w, regs, salt=salt, r_min=r_min, r_max=r_max)
    if regs.device.type != "cuda":
        raise ValueError(f"qsketch_update: unsupported device {regs.device}")
    scratch = regs.to(torch.int32)
    batch = lo.shape[0]
    if batch:
        KERNEL(
            regs.device, lo.data_ptr(), hi.data_ptr(), log2w.data_ptr(), batch,
            regs.shape[0], salt, r_min, r_max, scratch.data_ptr(),
        )
    return scratch.to(torch.int8)
