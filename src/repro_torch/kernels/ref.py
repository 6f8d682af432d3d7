"""Plain PyTorch versions of the kernels K1–K8, operand for operand.

Each function computes what its CUDA kernel computes, on the same operands,
with PyTorch tensor ops. The wrappers run them for CPU tensors; the tests
hold them against the JAX package's ``*_padded`` kernel entries; and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import torch

from ..core import estimators, hashing
from ..core.types import SketchConfig


def _y_table(lo, hi, log2w, m: int, *, salt: int, r_min: int, r_max: int):
    """float32[B, m] quantized values y_ij = clip(floor(log2 w_i - log2(-ln
    u_ij)), r_min, r_max); a NaN y (masked or zero-weight row whose -ln u
    rounded to 0) counts as r_min."""
    j = torch.arange(m, dtype=torch.int64, device=lo.device)
    e = hashing.neg_log_uniform((lo[:, None], hi[:, None], j[None, :]), salt)
    y = torch.floor(log2w[:, None] - torch.log2(e))
    return torch.clamp(torch.nan_to_num(y, nan=float(r_min)), float(r_min), float(r_max))


def qsketch_update_ref(lo, hi, log2w, regs, *, salt: int, r_min: int, r_max: int):
    """K1: int8[m] registers max-folded with y_ij over the batch.

    lo/hi int64[B] id words, log2w float32[B] (-inf on masked rows),
    regs int8[m].
    """
    if lo.shape[0] == 0:
        return regs.clone()
    y = _y_table(lo, hi, log2w, regs.shape[0], salt=salt, r_min=r_min, r_max=r_max)
    return torch.maximum(regs, y.amax(0).to(torch.int8))


def sketch_array_update_ref(lo, hi, log2w, keys, regs, *, salt: int, r_min: int, r_max: int):
    """K6: int8[K, m] registers with each batch row's y_i scatter-maxed into
    row keys[i] (int64, clipped to [0, K)). Returns a new tensor."""
    k, m = regs.shape
    if lo.shape[0] == 0:
        return regs.clone()
    y = _y_table(lo, hi, log2w, m, salt=salt, r_min=r_min, r_max=r_max).to(torch.int32)
    rows = torch.clamp(keys, 0, k - 1)[:, None].expand(-1, m)
    return regs.to(torch.int32).scatter_reduce(0, rows, y, "amax").to(torch.int8)


def float_sketch_update_ref(lo, hi, w, regs, *, salt: int):
    """K5: float32[m] min-registers folded with r_ij = (-ln u_ij) / w_i where
    w_i > 0, else float32 max (masked rows carry w = -1; NaN fails the test).

    lo/hi int64[B] id words, w float32[B], regs float32[m]. A true
    division, as the kernel and the JAX package compute it.
    """
    if lo.shape[0] == 0:
        return regs.clone()
    j = torch.arange(regs.shape[0], dtype=torch.int64, device=lo.device)
    e = hashing.neg_log_uniform((lo[:, None], hi[:, None], j[None, :]), salt)
    big = torch.full((), estimators.F32_MAX, dtype=torch.float32, device=lo.device)
    r = torch.where(w[:, None] > 0, e / w[:, None], big)
    return torch.minimum(regs, r.amin(0))


def virtual_pool_route_ref(lo, hi, t_lo, t_hi, log2w, *, salt_g: int, salt_h: int, salt_pool: int,
                           m: int, pool_size: int, r_min: int, r_max: int):
    """K8: (p int32[B], y int32[B]) per element: register choice
    j = hash_mod((lo, hi), salt_g, m); y = min(floor(log2 w - log2(-ln u)),
    r_max) with what is not finite set to r_min (QSketch-Dyn's y: no r_min
    clip); pool slot p = hash_mod((t_lo, t_hi, j), salt_pool, pool_size).
    All operands int64[B] id words and float32[B] log2 w."""
    j = hashing.hash_mod((lo, hi), salt_g, m)
    e = hashing.neg_log_uniform((lo, hi, j), salt_h)
    y = torch.clamp(torch.floor(log2w - torch.log2(e)), max=float(r_max))
    y = torch.where(torch.isfinite(y), y, torch.full_like(y, float(r_min)))
    p = hashing.hash_mod((t_lo, t_hi, j), salt_pool, pool_size)
    return p.to(torch.int32), y.to(torch.int32)


def qdyn_qr_ref(w, hist, scales, m: int):
    """K2: q_R = 1 - (1/m) Σ_k T[k] exp(-w s_k) for one histogram T (int32)."""
    expo = torch.exp(-w[:, None] * scales)
    return 1.0 - (hist.to(torch.float32) * expo).sum(-1) / m


def keyed_qr_ref(w, hists, keys, scales, m: int):
    """K3: q_R of element i against row keys[i] (clipped to [0, K)) of the
    int32 histogram block."""
    expo = torch.exp(-w[:, None] * scales)
    rows = hists[torch.clamp(keys, 0, hists.shape[0] - 1)]
    return 1.0 - (rows.to(torch.float32) * expo).sum(-1) / m


def estimate_rows_ref(cfg: SketchConfig, regs):
    """K4: per-row bincount + exactly 30 rebased, safeguarded Newton steps.

    regs int8[K, m] -> unscaled (chat f32[K], stddev f32[K], converged
    bool[K]); all-r_min rows report chat 0.
    """
    return estimators.newton_solve(
        cfg, estimators.histograms(cfg, regs), max_iters=30, tol=None
    )


def window_union_ref(regs, head, w: int, *, r_min: int, nb: int):
    """K7: full int32[K, nb] histograms of the max-union of the epoch planes
    of int8[E, K, m] ``regs`` whose age (head - e) mod E is below ``w``
    (``head`` an int32 0-dim tensor); bin v counts registers equal to
    v + r_min, so each row sums to m."""
    e, k, _ = regs.shape
    age = torch.remainder(head.to(torch.int64) - torch.arange(e, device=regs.device), e)
    floor = torch.full((), r_min, dtype=regs.dtype, device=regs.device)
    union = torch.where((age < w)[:, None, None], regs, floor).amax(0)
    idx = union.to(torch.int64) - r_min
    out = torch.zeros((k, nb), dtype=torch.int32, device=regs.device)
    return out.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
