"""K5 wrapper: the float min-sketch update of the LM baseline
(``csrc/float_sketch_update.cu``).

Replaces ``src/repro/kernels/qsketch_update.py:_float_kernel``. A CPU tensor
takes the plain version (``ref.float_sketch_update_ref``); a CUDA tensor
launches the kernel, which folds into a copy of the registers with an
int32 ``atomicMin`` on the float bits (every r is >= 0).
"""

from __future__ import annotations

from . import _build, ref

KERNEL = _build.Kernel(
    "float_sketch_update", "float_sketch_update_launch",
    [_build.P, _build.P, _build.P, _build.LL, _build.I, _build.U, _build.P],
)


def update_regs(lo, hi, w, regs, *, salt: int):
    """float32[m] registers after folding the batch (see
    ``ref.float_sketch_update_ref``); rows with w <= 0 or NaN are no-ops."""
    if regs.device.type == "cpu":
        return ref.float_sketch_update_ref(lo, hi, w, regs, salt=salt)
    if regs.device.type != "cuda":
        raise ValueError(f"float_sketch_update: unsupported device {regs.device}")
    out = regs.clone()
    batch = lo.shape[0]
    if batch:
        KERNEL(regs.device, lo.data_ptr(), hi.data_ptr(), w.data_ptr(), batch, regs.shape[0], salt,
               out.data_ptr())
    return out
