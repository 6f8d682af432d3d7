"""Baselines the paper compares against: Lemiesz's method, FastGM, FastExpSketch.

The port of ``repro/core/baselines.py``. All three share one sketch law —
m float min-registers, each the min of Exp(w) variables over distinct
elements, hence Exp(C) distributed — and the unbiased estimator
Ĉ = (m-1)/Σ R[j] (Eq. 2). They differ only in the update schedule:

* LM (Lemiesz [26]):  every element touches all m registers; kernel K5
                      (``kernels/float_sketch_update.py``) on a CUDA tensor.
* FastGM [45]:        ascending order-statistics draws placed by a hashed
                      permutation, with a batch-level prune against the
                      current max register.
* FastExpSketch [27]: FastGM's schedule under re-salted hashes, so the two
                      baselines are independent draws.

FastGM and FastExpSketch have no kernel in the JAX package either: they stay
plain PyTorch (a cumsum, a per-row stable argsort and a scatter-min).

Registers are float32, as in the JAX package. One deliberate difference:
``lm_update`` follows K5's semantics for a row whose weight is not positive
(w <= 0 or NaN leaves the registers unchanged), because the card's path and
the CPU path must agree; the JAX package's ``lm_update`` writes a negative
or NaN r into the registers there (ROADMAP queue 3).
"""

from __future__ import annotations

import torch

from . import estimators, hashing
from .types import FloatSketchState, SketchConfig, resolve_device

_INIT = estimators.F32_MAX


def init(cfg: SketchConfig, device="cuda") -> FloatSketchState:
    """Fresh float baseline sketch: float32[m] min-registers at float32 max."""
    dev = resolve_device(device)
    return FloatSketchState(regs=torch.full((cfg.m,), _INIT, dtype=torch.float32, device=dev))


def estimate(state: FloatSketchState) -> torch.Tensor:
    """Eq. 2 with the untouched-sketch guard (``estimators.lm_estimate``)."""
    return estimators.lm_estimate(state.regs)


def merge(a: FloatSketchState, b: FloatSketchState) -> FloatSketchState:
    """Exact union-stream merge: element-wise min."""
    return FloatSketchState(regs=torch.minimum(a.regs, b.regs))


# ---------------------------------------------------------------------------
# LM: dense iid schedule
# ---------------------------------------------------------------------------


def lm_update(cfg: SketchConfig, state: FloatSketchState, ids, weights, mask=None) -> FloatSketchState:
    """Alg. 1: R[j] <- min(R[j], -ln h_j(x)/w) for all j, batched (kernel K5
    on a CUDA tensor). Masked rows go to the kernel as w = -1, a no-op, as
    the JAX package's front pads them. Returns a new state."""
    from ..kernels import ops  # deferred: kernels import core

    lo, hi = hashing.split_id64(ids)
    w = weights.to(torch.float32)
    if mask is not None:
        w = torch.where(mask, w, torch.full_like(w, -1.0))
    regs = ops.float_sketch_update_op(cfg, state.regs, lo.contiguous(), hi.contiguous(), w.contiguous())
    return FloatSketchState(regs=regs)


# ---------------------------------------------------------------------------
# FastGM / FastExpSketch: order-statistics schedule + batch prune
# ---------------------------------------------------------------------------


def _os_values(cfg: SketchConfig, lo, hi, w, salt: int):
    """Ascending r_1 < ... < r_m per element via the FastGM recurrence."""
    m = cfg.m
    k = torch.arange(m, dtype=torch.int64, device=lo.device)
    e = hashing.neg_log_uniform((lo[:, None], hi[:, None], k[None, :]), salt)
    gaps = e / (m - torch.arange(m, dtype=torch.float32, device=lo.device))[None, :]
    return torch.cumsum(gaps, dim=-1) / w[:, None]


def _positions(cfg: SketchConfig, lo, hi, salt: int):
    """int64[B, m]: element i's k-th draw goes to register pos[i, k], a
    hashed permutation. Stable, as ``jnp.argsort`` is: 32-bit hash ties
    within one element's m keys do occur over long streams."""
    k = torch.arange(cfg.m, dtype=torch.int64, device=lo.device)
    keys = hashing.hash_words((lo[:, None], hi[:, None], k[None, :]), salt)
    return torch.argsort(keys, dim=-1, stable=True)


def _first_value(cfg: SketchConfig, lo, hi, w, salt_h: int):
    """r_1 = e_1/(m w), each element's smallest value (the prune bound)."""
    return hashing.neg_log_uniform((lo, hi, torch.zeros_like(lo)), salt_h) / (cfg.m * w)


def _fast_update(cfg: SketchConfig, state, ids, weights, mask, salt_h: int, salt_p: int):
    lo, hi = hashing.split_id64(ids)
    w = weights.to(torch.float32)
    # Prune: if r_1 >= the max register, the element cannot lower any.
    alive = _first_value(cfg, lo, hi, w, salt_h) < state.regs.max()
    if mask is not None:
        alive = alive & mask
    r = _os_values(cfg, lo, hi, w, salt_h)
    r = torch.where(alive[:, None], r, torch.full_like(r, _INIT))
    pos = _positions(cfg, lo, hi, salt_p)
    regs = state.regs.scatter_reduce(0, pos.reshape(-1), r.reshape(-1), "amin")
    return FloatSketchState(regs=regs)


def fastgm_update(cfg: SketchConfig, state: FloatSketchState, ids, weights, mask=None) -> FloatSketchState:
    """FastGM batched update: permuted one-register-per-draw min schedule
    under the config's primary salts. Returns a new state."""
    return _fast_update(cfg, state, ids, weights, mask, cfg.salt_h, cfg.salt_perm)


def fastexp_update(cfg: SketchConfig, state: FloatSketchState, ids, weights, mask=None) -> FloatSketchState:
    """FastExpSketch batched update: FastGM's schedule under re-salted
    hashes, so the two baselines are independent draws."""
    return _fast_update(
        cfg, state, ids, weights, mask,
        (cfg.salt_h * 31 + 7) & 0xFFFFFFFF, (cfg.salt_perm * 31 + 7) & 0xFFFFFFFF,
    )


def fastgm_prune_mask(cfg: SketchConfig, state: FloatSketchState, ids, weights):
    """Phase-1 survival mask (throughput benchmarks compact with this)."""
    lo, hi = hashing.split_id64(ids)
    return _first_value(cfg, lo, hi, weights.to(torch.float32), cfg.salt_h) < state.regs.max()
