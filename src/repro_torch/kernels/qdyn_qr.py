"""K2 wrapper: QSketch-Dyn q_R against one histogram (``csrc/keyed_qr.cu``).

Replaces ``src/repro/kernels/qdyn_qr.py:_qr_kernel``. A CPU tensor takes the
plain version (``ref.qdyn_qr_ref``); a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from . import _build, ref

KERNEL = _build.Kernel(
    "keyed_qr", "qdyn_qr_launch",
    [_build.P, _build.P, _build.P, _build.LL, _build.I, _build.I, _build.P],
)


def q_r(w, hist, scales, m: int):
    """float32[B] q_R (unfloored) of weights ``w`` against int32 ``hist``."""
    if w.device.type == "cpu":
        return ref.qdyn_qr_ref(w, hist, scales, m)
    if w.device.type != "cuda":
        raise ValueError(f"qdyn_qr: unsupported device {w.device}")
    q = torch.empty_like(w)
    if w.shape[0]:
        KERNEL(
            w.device, w.data_ptr(), hist.data_ptr(), scales.data_ptr(), w.shape[0],
            hist.shape[0], m, q.data_ptr(),
        )
    return q
