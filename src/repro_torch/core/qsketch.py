"""QSketch (paper §4.2): quantized max-sketch for weighted cardinality.

Update rule per element (x, w), for registers j = 1..m:

    y_j = floor(log2 w - log2 e_j),  e_j = -ln h_j(x)   (Exp(1), Eq. 5)
    R[j] <- max(R[j], clip(y_j, r_min, r_max))          (Eq. 6)

Max is commutative and associative, so one batched update equals the
paper's sequential Alg. 2 bit for bit (DESIGN.md §4.1). On a CUDA tensor
the batch runs in kernel K1 (``kernels/qsketch_update.py``); on a CPU
tensor in its plain PyTorch version. The order-statistics schedule
(``update_pruned``) is not ported yet.
"""

from __future__ import annotations

import torch

from . import estimation, estimators, hashing
from .types import QSketchState, SketchConfig, resolve_device


def init(cfg: SketchConfig, device="cuda") -> QSketchState:
    """Fresh QSketch: int8[m] registers at r_min (the empty-sketch value)."""
    dev = resolve_device(device)
    return QSketchState(regs=torch.full((cfg.m,), cfg.r_min, dtype=torch.int8, device=dev))


def quantized_values(cfg: SketchConfig, ids, weights):
    """The full (B, m) int8 table of quantized values y'_{ij}."""
    lo, hi = hashing.split_id64(ids)
    j = torch.arange(cfg.m, dtype=torch.int64, device=lo.device)
    e = hashing.neg_log_uniform((lo[:, None], hi[:, None], j[None, :]), cfg.salt_h)
    log2w = torch.log2(weights.to(torch.float32))[:, None]
    y = torch.floor(log2w - torch.log2(e))
    return torch.clamp(y, float(cfg.r_min), float(cfg.r_max)).to(torch.int8)


def update(cfg: SketchConfig, state: QSketchState, ids, weights, mask=None) -> QSketchState:
    """Batched exact update: R <- max(R, max_i y'_{ij}). Returns a new state.

    ``mask`` (bool[B]) disables padding rows: they enter as log2 w = -inf,
    whose y clips to r_min, a no-op under max.
    """
    from ..kernels import ops  # deferred: kernels import core

    lo, hi = hashing.split_id64(ids)
    log2w = torch.log2(weights.to(torch.float32))
    if mask is not None:
        log2w = torch.where(mask, log2w, torch.full_like(log2w, float("-inf")))
    regs = ops.qsketch_update_op(
        cfg, state.regs.contiguous(), lo.contiguous(), hi.contiguous(), log2w.contiguous()
    )
    return QSketchState(regs=regs)


def estimate(cfg: SketchConfig, state: QSketchState, *, solver: str = "newton"):
    """MLE estimate Ĉ (paper §4.2) — O(m) bincount + O(2^b) solve."""
    hist = estimators.histogram(cfg, state.regs)
    return estimation.estimate_hist(cfg, hist, kind="full", solver=solver)


def estimate_with_ci(cfg: SketchConfig, state: QSketchState, *, solver: str = "newton"):
    """(Ĉ, stddev, converged) via the observed-Fisher variance (paper §4.2)."""
    hist = estimators.histogram(cfg, state.regs)
    return estimation.estimate_hist_with_ci(cfg, hist, kind="full", solver=solver)


def merge(a: QSketchState, b: QSketchState) -> QSketchState:
    """Union-stream sketch: element-wise max (commutative monoid)."""
    return QSketchState(regs=torch.maximum(a.regs, b.regs))
