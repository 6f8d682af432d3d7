"""K3 wrapper: keyed q_R of the DynArray update (``csrc/keyed_qr.cu``).

Replaces ``src/repro/kernels/dyn_array_update.py:_keyed_qr_kernel``. Each
element's q_R reads its own key's batch-start histogram row; the kernel
reads the int32 row itself instead of a gathered f32 copy. A CPU tensor
takes the plain version (``ref.keyed_qr_ref``); a CUDA tensor launches the
kernel. The rest of the update (dedup, scatter-max, histogram moves,
martingale add) is PyTorch ops in ``core/dyn_array.py``, as the JAX package
leaves it to XLA.
"""

from __future__ import annotations

import torch

from . import _build, ref

KERNEL = _build.Kernel(
    "keyed_qr", "keyed_qr_launch",
    [_build.P, _build.P, _build.P, _build.P, _build.LL, _build.LL, _build.I, _build.I, _build.P],
)


def keyed_q_r(w, hists, keys, scales, m: int):
    """float32[B] q_R (unfloored): element i against ``hists[keys[i]]``
    (keys clipped to [0, K))."""
    if w.device.type == "cpu":
        return ref.keyed_qr_ref(w, hists, keys, scales, m)
    if w.device.type != "cuda":
        raise ValueError(f"dyn_array_update: unsupported device {w.device}")
    q = torch.empty_like(w)
    if w.shape[0]:
        KERNEL(
            w.device, w.data_ptr(), hists.data_ptr(), keys.data_ptr(),
            scales.data_ptr(), w.shape[0], hists.shape[0], hists.shape[1], m, q.data_ptr(),
        )
    return q
