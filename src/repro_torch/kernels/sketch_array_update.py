"""K6 wrapper: the keyed SketchArray register update
(``csrc/sketch_array_update.cu``).

Replaces ``src/repro/kernels/sketch_array_update.py:_sketch_array_kernel``.
Each element's K1 y-row is max-folded into register row ``keys[i]``. The
registers are updated in place: a CPU tensor takes the plain version
(``ref.sketch_array_update_ref``) and copies the result back; a CUDA tensor
launches the kernel, which raises int8 registers through 32-bit
compare-and-swap on the words that hold them.
"""

from __future__ import annotations

from . import _build, ref

KERNEL = _build.Kernel(
    "sketch_array_update", "sketch_array_update_launch",
    [_build.P, _build.P, _build.P, _build.P, _build.LL, _build.LL, _build.I,
     _build.U, _build.I, _build.I, _build.P],
)


def update_regs(lo, hi, log2w, keys, regs, *, salt: int, r_min: int, r_max: int):
    """Fold the batch into int8[K, m] ``regs`` in place and return it (see
    ``ref.sketch_array_update_ref``)."""
    if regs.device.type == "cpu":
        return regs.copy_(ref.sketch_array_update_ref(
            lo, hi, log2w, keys, regs, salt=salt, r_min=r_min, r_max=r_max))
    if regs.device.type != "cuda":
        raise ValueError(f"sketch_array_update: unsupported device {regs.device}")
    # The kernel's compare-and-swap works on aligned 32-bit words; the
    # caching allocator rounds blocks to 512 bytes, so the last word of the
    # block is always inside it.
    if regs.data_ptr() % 4:
        raise ValueError("sketch_array_update: the register block must start 4-byte aligned")
    batch = lo.shape[0]
    if batch:
        KERNEL(
            regs.device, lo.data_ptr(), hi.data_ptr(), log2w.data_ptr(), keys.data_ptr(),
            batch, regs.shape[0], regs.shape[1], salt, r_min, r_max, regs.data_ptr(),
        )
    return regs
