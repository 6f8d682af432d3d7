"""K7 wrapper: fused epoch-window union + per-row full histogram
(``csrc/window_union.cu``).

Replaces ``src/repro/kernels/window_union.py:_window_union_kernel``. The
windowed read of the epoch ring needs, per tenant row, the full value
histogram of the max-union of the planes inside the window; the kernel
streams the included int8 planes once and writes only the int32
histograms (the ``[w, K, m]`` gather and the union never exist in HBM).
The window's planes are chosen on the device from the ring's ``head``
tensor, so the read needs no host sync. A CPU tensor takes the plain
version (``ref.window_union_ref``); a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from . import _build, ref

KERNEL = _build.Kernel(
    "window_union", "window_union_launch",
    [_build.P, _build.P, _build.I, _build.LL, _build.I, _build.I, _build.I, _build.I, _build.P],
)


def union_hists(regs, head, w: int, *, r_min: int, nb: int):
    """int32[K, nb] full histograms of the union of the last ``w`` epochs
    (see ``ref.window_union_ref``)."""
    if regs.device.type == "cpu":
        return ref.window_union_ref(regs, head, w, r_min=r_min, nb=nb)
    if regs.device.type != "cuda":
        raise ValueError(f"window_union: unsupported device {regs.device}")
    e, k, m = regs.shape
    hist = torch.empty((k, nb), dtype=torch.int32, device=regs.device)
    if k:
        KERNEL(
            regs.device, regs.data_ptr(), head.data_ptr(), e, k, m, int(w), r_min, nb,
            hist.data_ptr(),
        )
    return hist
