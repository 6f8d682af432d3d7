"""Validated fronts of the ported kernels (K1–K8).

Each front takes the sketch configuration and the kernel's operands as the
core modules hold them, checks them — every operand on one CPU or CUDA
device, of the expected dtype and shape, contiguous — and raises on
anything else, then calls the kernel's wrapper, which dispatches on the
device: the plain PyTorch version for CPU tensors, the CUDA kernel for CUDA
tensors.

Unlike the JAX package's fronts, these stop at the kernel boundary: the
update tails (dedup, scatters, histogram moves) live in the core modules,
which call the fronts, so core and kernels do not import each other in a
circle.

Launch counts: each kernel wrapper counts its own launches
(``_build.Kernel.launches``); ``launch_counts`` reads them and
``reset_launch_counts`` sets them to 0.
"""

from __future__ import annotations

import functools

import torch

from ..core import estimators
from ..core.types import SketchConfig
from . import (
    dyn_array_update,
    estimate,
    float_sketch_update,
    qdyn_qr,
    qsketch_update,
    sketch_array_update,
    virtual_pool_update,
    window_union,
)

KERNELS = {
    "qsketch_update": qsketch_update.KERNEL,
    "qdyn_qr": qdyn_qr.KERNEL,
    "dyn_array_update": dyn_array_update.KERNEL,
    "estimate": estimate.KERNEL,
    "float_sketch_update": float_sketch_update.KERNEL,
    "sketch_array_update": sketch_array_update.KERNEL,
    "window_union": window_union.KERNEL,
    "virtual_pool_route": virtual_pool_update.KERNEL,
}

QR_FLOOR = 1e-12  # q_R guard; only reachable when a sketch is fully saturated


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0


def _device(t: torch.Tensor, what: str) -> torch.device:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device


def _check(t, what: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device`` whose
    shape matches ``shape`` (a None entry matches any length)."""
    if _device(t, what) != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


@functools.lru_cache(maxsize=16)
def _scales(cfg: SketchConfig, device: torch.device) -> torch.Tensor:
    return estimators.bin_scales(cfg, device)


def scales(cfg: SketchConfig, device) -> torch.Tensor:
    """s_k = 2^-(k + r_min + 1) as float32[2^b] on ``device`` (cached)."""
    return _scales(cfg, torch.device(device))


def qsketch_update_op(cfg: SketchConfig, regs, lo, hi, log2w):
    """K1: int8[m] registers after folding a batch (masked rows carry
    log2w = -inf). lo/hi int64[B], log2w float32[B], regs int8[m]."""
    dev = _device(regs, "regs")
    _check(regs, "regs", torch.int8, (cfg.m,), dev)
    _check(lo, "lo", torch.int64, (None,), dev)
    _check(hi, "hi", torch.int64, lo.shape, dev)
    _check(log2w, "log2w", torch.float32, lo.shape, dev)
    return qsketch_update.update_regs(
        lo, hi, log2w, regs, salt=cfg.salt_h, r_min=cfg.r_min, r_max=cfg.r_max
    )


def float_sketch_update_op(cfg: SketchConfig, regs, lo, hi, w):
    """K5: float32[m] min-registers after folding a batch (rows with w <= 0
    or NaN — masked rows carry w = -1 — are no-ops). lo/hi int64[B], w
    float32[B], regs float32[m]."""
    dev = _device(regs, "regs")
    _check(regs, "regs", torch.float32, (cfg.m,), dev)
    _check(lo, "lo", torch.int64, (None,), dev)
    _check(hi, "hi", torch.int64, lo.shape, dev)
    _check(w, "w", torch.float32, lo.shape, dev)
    return float_sketch_update.update_regs(lo, hi, w, regs, salt=cfg.salt_h)


def virtual_pool_route_op(cfg: SketchConfig, m_v: int, salt_pool: int, pool_size: int,
                          lo, hi, t_lo, t_hi, log2w):
    """K8: (p int32[B] pool slots, y int32[B] values) of a batch of
    elements (lo/hi int64[B]) of tenants (t_lo/t_hi int64[B]) with log2
    weights log2w float32[B], under the tail geometry: register choice
    modulo ``m_v``, the quantization range and hash salts of ``cfg``, and
    pool placement by ``salt_pool`` modulo ``pool_size``."""
    dev = _device(lo, "lo")
    _check(lo, "lo", torch.int64, (None,), dev)
    for name, t in (("hi", hi), ("t_lo", t_lo), ("t_hi", t_hi)):
        _check(t, name, torch.int64, lo.shape, dev)
    _check(log2w, "log2w", torch.float32, lo.shape, dev)
    if not 0 < m_v < 2**31 or not 0 < pool_size < 2**31:
        raise ValueError(f"m_v={m_v} and pool_size={pool_size} must lie in (0, 2^31)")
    return virtual_pool_update.route(
        lo, hi, t_lo, t_hi, log2w, salt_g=cfg.salt_g, salt_h=cfg.salt_h, salt_pool=salt_pool,
        m=m_v, pool_size=pool_size, r_min=cfg.r_min, r_max=cfg.r_max,
    )


def sketch_array_update_op(cfg: SketchConfig, regs, keys, lo, hi, log2w):
    """K6: fold a keyed batch into int8[K, m] registers IN PLACE and return
    them. keys int64[B] (clipped to [0, K)), lo/hi int64[B], log2w
    float32[B] (-inf on masked rows)."""
    dev = _device(regs, "regs")
    _check(regs, "regs", torch.int8, (None, cfg.m), dev)
    _check(lo, "lo", torch.int64, (None,), dev)
    _check(hi, "hi", torch.int64, lo.shape, dev)
    _check(keys, "keys", torch.int64, lo.shape, dev)
    _check(log2w, "log2w", torch.float32, lo.shape, dev)
    return sketch_array_update.update_regs(
        lo, hi, log2w, keys, regs, salt=cfg.salt_h, r_min=cfg.r_min, r_max=cfg.r_max
    )


def window_union_op(cfg: SketchConfig, regs, head, w: int):
    """K7: full int32[K, 2^b] histograms of the max-union of the last ``w``
    epoch planes of the int8[E, K, m] ring (``head``: int32 0-dim tensor,
    the ring slot of the current epoch; 1 <= w <= E)."""
    dev = _device(regs, "regs")
    _check(regs, "regs", torch.int8, (None, None, cfg.m), dev)
    _check(head, "head", torch.int32, (), dev)
    if not 1 <= int(w) <= regs.shape[0]:
        raise ValueError(f"window w={w} out of range [1, E={regs.shape[0]}]")
    return window_union.union_hists(regs, head, int(w), r_min=cfg.r_min, nb=cfg.num_bins)


def qdyn_qr_op(cfg: SketchConfig, hist, weights):
    """K2: q_R of float32[B] weights against one int32[2^b] histogram,
    floored at ``QR_FLOOR``."""
    dev = _device(weights, "weights")
    _check(weights, "weights", torch.float32, (None,), dev)
    _check(hist, "hist", torch.int32, (cfg.num_bins,), dev)
    q = qdyn_qr.q_r(weights, hist, scales(cfg, dev), cfg.m)
    return torch.clamp(q, min=QR_FLOOR)


def dyn_array_update_op(cfg: SketchConfig, hists, keys, weights):
    """K3 — the kernel stage of the DynArray update: q_R of element i
    against its key's batch-start histogram row ``hists[keys[i]]``
    (int32[K, 2^b]; keys int64[B], clipped to [0, K)), floored at
    ``QR_FLOOR``."""
    dev = _device(weights, "weights")
    _check(weights, "weights", torch.float32, (None,), dev)
    _check(keys, "keys", torch.int64, weights.shape, dev)
    _check(hists, "hists", torch.int32, (None, cfg.num_bins), dev)
    q = dyn_array_update.keyed_q_r(weights, hists, keys, scales(cfg, dev), cfg.m)
    return torch.clamp(q, min=QR_FLOOR)


def estimate_rows_op(cfg: SketchConfig, regs, *, kind: str = "routed"):
    """K4 — the ``fused`` solver: (Ĉ[K], stddev[K], converged[K]) of
    int8[K, m] register rows. ``"full"`` returns the MLE; ``"routed"``
    scales ×m (all-r_min rows are exactly 0 inside the kernel)."""
    if kind not in ("full", "routed"):
        raise ValueError(f"unknown kind {kind!r}; expected 'full' or 'routed'")
    dev = _device(regs, "regs")
    _check(regs, "regs", torch.int8, (None, cfg.m), dev)
    chat, std, conv = estimate.estimate_rows(cfg, regs)
    if kind == "routed":
        return chat * cfg.m, std * cfg.m, conv
    return chat, std, conv
