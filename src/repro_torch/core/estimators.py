"""Weighted-cardinality estimators in histogram form (paper §4.2).

The port of ``repro/core/estimators.py``:

* ``lm_estimate``    — Eq. 2 for the float min-register baselines;
* ``histogram`` / ``histograms`` — register-value histograms (2^b bins);
* ``qsketch_init``   — the Newton seed Ĉ0 = (m-1) / Σ 2^{-R[j]};
* ``_f_and_fprime``  — score and derivative of the truncated quantized
                       likelihood, term for term as in the JAX package;
* ``qsketch_mle``    — the rebased, safeguarded Newton, batched over rows;
* ``mle_numpy``      — the float64 numpy oracle (a copy of the JAX
                       package's, which is numpy only).

Every function is batched over leading dimensions: a histogram block
``[..., 2^b]`` solves every row at once, each row with its own stopping
rule, which is what a vmapped ``lax.while_loop`` computes in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import SketchConfig

_EPS_Z = 1e-4  # series-switch threshold for z = C*s
F32_MAX = float(np.finfo(np.float32).max)  # untouched float min-register


def lm_estimate(regs: torch.Tensor) -> torch.Tensor:
    """Unbiased estimator for LM/FastGM/FastExp float min-registers (Eq. 2):
    Ĉ = (m-1) / Σ R[j].

    A register still at its init sentinel (float32 max) was never touched.
    If NO register was touched the stream is empty and the estimate is
    exactly 0.0 (the sum at float32-max scale would otherwise give a tiny
    nonzero value); partially touched sketches estimate through Eq. 2.
    """
    m = regs.shape[0]
    untouched = regs.min() >= F32_MAX
    total = regs.sum()
    est = torch.full_like(total, float(m - 1)) / total  # a true division
    return torch.where(untouched, torch.zeros_like(est), est)


def histogram(cfg: SketchConfig, regs: torch.Tensor) -> torch.Tensor:
    """Register-value histogram T with 2^b bins; bin k counts value k+r_min."""
    return histograms(cfg, regs[None, :])[0]


def histograms(cfg: SketchConfig, regs: torch.Tensor) -> torch.Tensor:
    """Per-row histograms ``int32[K, 2^b]`` of an ``int8[K, m]`` register block."""
    idx = regs.to(torch.int64) - cfg.r_min
    out = torch.zeros((regs.shape[0], cfg.num_bins), dtype=torch.int32, device=regs.device)
    return out.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))


def _bin_scales(cfg: SketchConfig) -> np.ndarray:
    """s_k = 2^{-(k + r_min + 1)} for k = 0..2^b-1, as float32-exact values."""
    ks = np.arange(cfg.num_bins, dtype=np.float64) + cfg.r_min + 1.0
    return np.exp2(-ks).astype(np.float32)


def bin_scales(cfg: SketchConfig, device) -> torch.Tensor:
    """``_bin_scales`` as a float32 tensor on ``device``."""
    return torch.from_numpy(_bin_scales(cfg)).to(device)


def qsketch_init(cfg: SketchConfig, hist: torch.Tensor) -> torch.Tensor:
    """Newton seed Ĉ0 = (m-1) / Σ_j 2^{-R[j]}  (histogram form)."""
    s = bin_scales(cfg, hist.device)
    denom = (hist.to(torch.float32) * s * 2.0).sum(-1)
    return (cfg.m - 1) / torch.clamp(denom, min=1e-38)


def _f_and_fprime(cfg: SketchConfig, t, c, s):
    """Score f(C) and derivative f'(C) of the truncated quantized likelihood.

    ``t`` float32 ``[..., 2^b]`` histogram counts, ``c`` ``[..., 1]``, ``s``
    the (possibly rebased) per-bin scales ``[..., 2^b]``. Bin 0 (r_min)
    contributes the constant -s_0 to f and 0 to f'; the top bin (r_max)
    contributes a/expm1(C·a) with a = 2·s[top]; interior bins
    s/expm1(Cs) - s. The derivative is evaluated in log space so every
    term is finite across the full dynamic range (0·nan must never reach
    the sum).
    """
    top = cfg.top_bin

    def f_term(scale):
        z = c * scale
        zz = torch.clamp(z, _EPS_Z, 88.0)  # expm1(88) < f32 max
        return torch.where(z < _EPS_Z, 1.0 / c - 0.5 * scale, scale / torch.expm1(zz))

    def fp_term(scale):
        z = c * scale
        zz = torch.clamp(z, min=_EPS_Z)
        lsh = torch.where(
            zz > 40.0, zz / 2.0, torch.log(2.0 * torch.sinh(torch.clamp(zz, max=40.0) / 2.0))
        )
        return torch.where(
            z < _EPS_Z, -1.0 / (c * c), -torch.exp(2.0 * (torch.log(scale) - lsh))
        )

    a = 2.0 * s[..., top : top + 1]
    lane = torch.arange(cfg.num_bins, device=t.device)
    f_terms = torch.where(
        lane == 0, -s[..., 0:1], torch.where(lane == top, f_term(a), f_term(s) - s)
    )
    fp_terms = torch.where(
        lane == 0, torch.zeros_like(s), torch.where(lane == top, fp_term(a), fp_term(s))
    )
    return (t * f_terms).sum(-1, keepdim=True), (t * fp_terms).sum(-1, keepdim=True)


def _guard(fp):
    return torch.where(fp.abs() > 0, fp, torch.full_like(fp, -1e-30))


def newton_solve(cfg: SketchConfig, hist, *, max_iters: int, tol: float | None):
    """Rebased, safeguarded Newton on full histograms ``[..., 2^b]``.

    Returns the unscaled (chat, stddev, converged) per row. With ``tol``
    a row stops once a step moves C by at most tol·C (``qsketch_mle``);
    with ``tol=None`` every row runs exactly ``max_iters`` steps (the fixed
    schedule of the fused estimate kernel). Degenerate rows (all r_min or
    all r_max — no interior extremum) keep the seed; all-r_min rows
    report 0.
    """
    m = cfg.m
    t = hist.to(torch.float32)
    degenerate = (t[..., 0:1] == m) | (t[..., cfg.top_bin : cfg.top_bin + 1] == m)

    kval = torch.arange(cfg.num_bins, dtype=torch.float32, device=t.device) + float(cfg.r_min)
    delta = torch.round((t * kval).sum(-1, keepdim=True) / m)
    s = torch.exp2(torch.clamp(delta - (kval + 1.0), -126.0, 126.0))

    c = (m - 1) / torch.clamp((t * s * 2.0).sum(-1, keepdim=True), min=1e-30)
    c = torch.clamp(c, 1e-20, 1e20)

    done = degenerate.clone()
    for _ in range(max_iters):
        if tol is not None and bool(done.all()):
            break
        f, fp = _f_and_fprime(cfg, t, c, s)
        c_new = c - f / _guard(fp)
        c_new = torch.minimum(torch.maximum(c_new, c / 8.0), c * 8.0)
        c_new = torch.clamp(c_new, min=1e-30)
        if tol is None:
            c = torch.where(degenerate, c, c_new)
        else:
            c_next = torch.where(done, c, c_new)
            done = done | ((c_new - c).abs() <= tol * c)
            c = c_next
    _, fp = _f_and_fprime(cfg, t, c, s)
    std = torch.sqrt(torch.clamp(-1.0 / _guard(fp), min=0.0))
    scale_back = torch.exp2(delta)
    chat = torch.where(t[..., 0:1] == m, torch.zeros_like(c), c * scale_back)
    return chat[..., 0], (std * scale_back)[..., 0], ~degenerate[..., 0]


def qsketch_mle(cfg: SketchConfig, hist, max_iters: int = 60, tol: float = 1e-6):
    """MLE Ĉ from register histograms via safeguarded Newton–Raphson.

    ``hist`` is one full histogram ``[2^b]`` or a block ``[K, 2^b]``.
    Returns (chat, stddev, converged) — see ``newton_solve``.
    """
    return newton_solve(cfg, hist, max_iters=max_iters, tol=tol)


# ---------------------------------------------------------------------------
# float64 numpy oracle (tests + accuracy checks)
# ---------------------------------------------------------------------------


def mle_numpy(cfg: SketchConfig, regs: np.ndarray, max_iters: int = 200, tol: float = 1e-12) -> float:
    """Reference float64 MLE identical in form to ``qsketch_mle``."""
    regs = np.asarray(regs, dtype=np.int64)
    hist = np.bincount(regs - cfg.r_min, minlength=cfg.num_bins).astype(np.float64)
    nb = cfg.num_bins
    ks = np.arange(nb, dtype=np.float64) + cfg.r_min + 1.0
    s = np.exp2(-ks)

    top = cfg.top_bin
    if hist[0] == cfg.m:
        return 0.0
    denom = float(np.sum(hist * s * 2.0))
    c = max((cfg.m - 1) / denom, 1e-300)
    if hist[top] == cfg.m:
        return c  # degenerate-high: fall back to seed

    def f_fp(c):
        z = c * s
        with np.errstate(over="ignore", under="ignore", divide="ignore", invalid="ignore"):
            zz = np.clip(z, 1e-12, 700.0)  # expm1(700) < f64 max
            em1 = np.expm1(zz)
            f_terms = np.where(z < 1e-12, 1.0 / c - 1.5 * s, s / em1 - s)
            # -(s / (2 sinh(z/2)))^2 in log space to stay finite everywhere.
            lsh = np.where(zz > 40.0, zz / 2.0, np.log(2.0 * np.sinh(np.minimum(zz, 40.0) / 2.0)))
            lz = np.maximum(c * s, 1e-300)  # true z for the z/2 asymptote
            lsh = np.where(lz > 700.0, lz / 2.0, lsh)
            fp_terms = np.where(z < 1e-12, -1.0 / c**2, -np.exp(2.0 * (np.log(s) - lsh)))
            a = 2.0 * s[top]
            za = np.clip(c * a, 1e-12, 700.0)
            f_terms[top] = 1.0 / c - 0.5 * a if c * a < 1e-12 else a / np.expm1(za)
            lsha = za / 2.0 if za > 40.0 else np.log(2.0 * np.sinh(za / 2.0))
            fp_terms[top] = -1.0 / c**2 if c * a < 1e-12 else -np.exp(2.0 * (np.log(a) - lsha))
            f_terms[0] = -s[0]
            fp_terms[0] = 0.0
        return float(np.sum(hist * f_terms)), float(np.sum(hist * fp_terms))

    for _ in range(max_iters):
        f, fp = f_fp(c)
        if fp == 0.0:
            break
        c_new = float(np.clip(c - f / fp, c / 8.0, c * 8.0))
        c_new = max(c_new, 1e-300)
        if abs(c_new - c) <= tol * c:
            c = c_new
            break
        c = c_new
    return c
