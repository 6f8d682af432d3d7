"""K8 wrapper: per-element pool placement of the virtual tier
(``csrc/virtual_pool_route.cu``).

Replaces ``src/repro/kernels/virtual_pool_update.py:_pool_route_kernel``. A
pure per-element hash, no state read: register choice j, quantized value y
and pool slot p. A CPU tensor takes the plain version
(``ref.virtual_pool_route_ref``); a CUDA tensor launches the kernel. The
data-dependent tail (hot/tail split, slot-grouped scatter-max, histogram
moves) is PyTorch ops in ``core/virtual_dyn_array.py``.
"""

from __future__ import annotations

import torch

from . import _build, ref

KERNEL = _build.Kernel(
    "virtual_pool_route", "virtual_pool_route_launch",
    [_build.P, _build.P, _build.P, _build.P, _build.P, _build.LL, _build.U, _build.U, _build.U,
     _build.U, _build.U, _build.I, _build.I, _build.P, _build.P],
)


def route(lo, hi, t_lo, t_hi, log2w, *, salt_g: int, salt_h: int, salt_pool: int, m: int,
          pool_size: int, r_min: int, r_max: int):
    """(p int32[B] pool slots, y int32[B] values); see ``ref.virtual_pool_route_ref``."""
    args = dict(salt_g=salt_g, salt_h=salt_h, salt_pool=salt_pool, m=m, pool_size=pool_size,
                r_min=r_min, r_max=r_max)
    if lo.device.type == "cpu":
        return ref.virtual_pool_route_ref(lo, hi, t_lo, t_hi, log2w, **args)
    if lo.device.type != "cuda":
        raise ValueError(f"virtual_pool_route: unsupported device {lo.device}")
    batch = lo.shape[0]
    p = torch.empty((batch,), dtype=torch.int32, device=lo.device)
    y = torch.empty((batch,), dtype=torch.int32, device=lo.device)
    if batch:
        KERNEL(lo.device, lo.data_ptr(), hi.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr(),
               log2w.data_ptr(), batch, salt_g, salt_h, salt_pool, m, pool_size, r_min, r_max,
               p.data_ptr(), y.data_ptr())
    return p, y
