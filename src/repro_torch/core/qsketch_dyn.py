"""QSketch-Dyn (paper §4.3): O(1)-update anytime weighted-cardinality tracking.

Per element (x, w):
  1. pick ONE register j = g(x);
  2. y = floor(-log2(-ln h_j(x) / w));
  3. if y > R[j]: move histogram mass T[R[j]] -> T[y], set R[j] = y;
  4. Ĉ += 1(changed) · w / q_R, with the update probability
         q_R = 1 - (1/m) Σ_k T[k] e^{-w 2^{-(k+r_min+1)}}
     computed from the state BEFORE the update (Eq. 12 / Thm. 2).

Two execution modes, as in the JAX package:

* ``update_scan``  — the exact sequential chain, element by element (the
                     oracle).
* ``update_batch`` — all q_R from the batch-start histogram (kernel K2 on a
                     CUDA tensor), exact within-batch dedup, one scatter-max
                     and a histogram rebuild.
"""

from __future__ import annotations

import torch

from . import estimation, estimators, hashing
from .types import DynState, SketchConfig, resolve_device

def init(cfg: SketchConfig, device="cuda") -> DynState:
    """Fresh QSketch-Dyn: registers at r_min, zero touched-register
    histogram, zero running martingale estimate."""
    dev = resolve_device(device)
    return DynState(
        regs=torch.full((cfg.m,), cfg.r_min, dtype=torch.int8, device=dev),
        hist=torch.zeros((cfg.num_bins,), dtype=torch.int32, device=dev),
        chat=torch.zeros((), dtype=torch.float32, device=dev),
    )


def _choose_and_quantize(cfg: SketchConfig, lo, hi, w):
    """(j int64, y int32) per element: register choice g(x) and quantized value."""
    j = hashing.hash_mod((lo, hi), cfg.salt_g, cfg.m)
    e = hashing.neg_log_uniform((lo, hi, j), cfg.salt_h)
    y = torch.floor(torch.log2(w) - torch.log2(e))
    # No r_min clip needed: y must exceed R[j] >= r_min to matter. Cap at r_max.
    y = torch.clamp(y, max=float(cfg.r_max))
    # Degenerate w gives -inf/NaN; quantize it to a harmless floor.
    y = torch.where(torch.isfinite(y), y, torch.full_like(y, float(cfg.r_min)))
    return j, y.to(torch.int32)


def _q_update_prob(cfg: SketchConfig, hist, w):
    """q_R of float32[B] weights against the int32 histogram T (kernel K2 on
    a CUDA tensor), floored at ``ops.QR_FLOOR`` (1e-12).

    Untouched registers (still r_min) are absent from T: their term is ~0,
    so q_R treats them as always updatable (Alg. 3 inits T to zeros).
    """
    from ..kernels import ops  # deferred: kernels import core

    return ops.qdyn_qr_op(cfg, hist.contiguous(), w.contiguous())


def _live_weight_mask(w, mask):
    """Rows that may touch the sketch: caller mask AND a usable weight.

    Non-positive / non-finite weights are dropped as if masked, so a
    degenerate duplicate can never shadow a live row of the same id.
    """
    live = torch.isfinite(w) & (w > 0)
    return live if mask is None else live & mask


def first_live_occurrence(keys, lo, hi, live):
    """Mask of each (key, id) group's first row, live rows ordered first.

    The order is the JAX package's ``lexsort((dead, lo, hi, keys))``: two
    stable sorts, by (lo, dead) and then by (key, hi), give the same groups
    with live rows ahead of dead ones and batch order among equals — so the
    first-occurrence winner of a group holding a live row is live, and it is
    the same row the JAX package picks. ``keys`` must lie in [0, 2^31).
    """
    dead = (~live).to(torch.int64)
    o1 = torch.sort((lo << 1) | dead, stable=True).indices
    major = (keys << 32) | hi
    order = o1[torch.sort(major[o1], stable=True).indices]
    s_major, s_lo = major[order], lo[order]
    first = torch.ones_like(live)
    first[1:] = (s_major[1:] != s_major[:-1]) | (s_lo[1:] != s_lo[:-1])
    out = torch.empty_like(first)
    out[order] = first
    return out


def _dedup_mask(lo, hi, live):
    """Exact within-batch first-occurrence mask of the id pair (live first)."""
    return first_live_occurrence(torch.zeros_like(lo), lo, hi, live)


def update_scan(cfg: SketchConfig, state: DynState, ids, weights, mask=None) -> DynState:
    """Exact sequential update of a batch (Alg. 3 semantics, Eq. 12 estimator).

    Degenerate (non-positive / non-finite) weights are dropped as if masked.
    The oracle: one element at a time, each q_R from the current histogram.
    """
    lo, hi = hashing.split_id64(ids)
    w = weights.to(torch.float32)
    live = _live_weight_mask(w, mask)
    j, y = _choose_and_quantize(cfg, lo, hi, w)
    regs, hist, chat = state.regs.clone(), state.hist.clone(), state.chat.clone()
    for i in range(w.shape[0]):
        q = _q_update_prob(cfg, hist, w[i : i + 1])[0]
        ji = j[i]
        old = regs[ji].to(torch.int32)
        if bool(live[i]) and bool(y[i] > old):
            ob = old - cfg.r_min
            if bool(hist[ob] > 0):
                hist[ob] -= 1
            hist[y[i] - cfg.r_min] += 1
            regs[ji] = y[i].to(torch.int8)
            chat = chat + w[i] / q
    return DynState(regs=regs, hist=hist, chat=chat)


def _touched_hist(cfg: SketchConfig, regs):
    hist = estimators.histogram(cfg, regs)
    hist[0] = 0
    return hist


def update_batch(cfg: SketchConfig, state: DynState, ids, weights, mask=None) -> DynState:
    """Batch-stale update: q_R and change indicators from the batch-start
    state. Returns a new state.

    Exact within-batch dedup; register scatter-max; histogram rebuilt from
    registers. First occurrence is decided among *live* rows only — masked
    rows and degenerate weights never shadow a live row sharing their id.
    """
    lo, hi = hashing.split_id64(ids)
    w = weights.to(torch.float32)
    j, y = _choose_and_quantize(cfg, lo, hi, w)

    live = _live_weight_mask(w, mask)
    alive = _dedup_mask(lo, hi, live) & live

    old = state.regs[j].to(torch.int32)
    changed = alive & (y > old)
    q = _q_update_prob(cfg, state.hist, w)
    chat = state.chat + torch.where(changed, w / q, torch.zeros_like(w)).sum()

    y_eff = torch.where(changed, y, torch.full_like(y, cfg.r_min))
    regs = state.regs.to(torch.int32).scatter_reduce(0, j, y_eff, "amax").to(torch.int8)
    return DynState(regs=regs, hist=_touched_hist(cfg, regs), chat=chat)


def estimate(state: DynState):
    """Anytime estimate: the running martingale (O(0) per query)."""
    return state.chat


def estimate_mle(cfg: SketchConfig, state: DynState):
    """Histogram-MLE re-estimate from the registers (routed convention:
    ×m, untouched state reads 0)."""
    hist = estimators.histogram(cfg, state.regs)
    return estimation.estimate_hist(cfg, hist, kind="routed")


def merge(cfg: SketchConfig, a: DynState, b: DynState) -> DynState:
    """Merge sketches of disjoint/overlapping sub-streams.

    Registers: element-wise max. Histogram: rebuilt. Running Ĉ:
    re-estimated via the MLE — running estimates are not additive when
    sub-streams may share elements.
    """
    regs = torch.maximum(a.regs, b.regs)
    hist = _touched_hist(cfg, regs)
    full_hist = hist.clone()
    full_hist[0] = cfg.m - hist.sum()
    chat = estimation.estimate_hist(cfg, full_hist, kind="routed")
    return DynState(regs=regs, hist=hist, chat=chat)
