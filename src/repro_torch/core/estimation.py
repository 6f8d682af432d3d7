"""Unified estimation layer: the histogram→Ĉ solve behind one API.

The port of ``repro/core/estimation.py`` for two of its solvers:

``newton``
    The safeguarded Newton of ``estimators.qsketch_mle`` (each row stops on
    its own tolerance, at most 60 steps).
``fused``
    The fused bincount + fixed 30-step Newton of kernel K4
    (``kernels/estimate.py``) through ``ops.estimate_rows_op``: register
    rows in, (Ĉ, stddev, converged) out, the ``[K, 2^b]`` histogram block
    never materialised on the card. Registers only —
    ``estimate_hists(solver="fused")`` raises.

The ``lut`` solver is not ported yet; asking for it raises.

The pooled solves of the register-sharing tier (``pool_config``,
``estimate_hists_virtual``, ``estimate_rows_virtual``,
``estimate_pool_hist``, ``cancel_pool_noise``) are a compound-Poisson
profile solve on a nested grid, plain PyTorch as in the JAX package.

Scaling conventions (``kind=``): ``"full"`` — every element feeds all m
registers (QSketch, the in-step monitor); the MLE *is* Ĉ. ``"routed"`` —
one register per element (Dyn rows); Ĉ = m·MLE, and untouched rows
(full-histogram bin 0 == m) report exactly 0.0.

Tolerance semantics: ``fused`` matches the float64 reference MLE within
``LUT_RTOL`` relative error or ``ATOL_FLOOR`` absolute.
"""

from __future__ import annotations

import numpy as np
import torch

from . import estimators
from .types import SketchConfig

LUT_RTOL = 2e-3
ATOL_FLOOR = 1e-6

SOLVERS = ("newton", "fused")


def _check_kind(kind: str) -> None:
    if kind not in ("full", "routed"):
        raise ValueError(f"unknown kind {kind!r}; expected 'full' or 'routed'")


def _check_solver(solver: str, *, hists_input: bool = False) -> None:
    if solver == "lut":
        raise ValueError("solver='lut' is not ported yet; use 'newton' or 'fused'")
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; expected one of {SOLVERS}")
    if hists_input and solver == "fused":
        raise ValueError(
            "solver='fused' streams register rows (its point is fusing the "
            "bincount) — use estimate_rows"
        )


def _routed_chat(cfg: SketchConfig, hist0, chat):
    """The ×m scaling + untouched-row Ĉ=0 guard of the routed convention."""
    return torch.where(hist0 == cfg.m, torch.zeros_like(chat), chat * cfg.m)


def _hists_with_ci_impl(cfg: SketchConfig, hists, *, kind, solver):
    _check_kind(kind)
    _check_solver(solver, hists_input=True)
    chat, stddev, ok = estimators.qsketch_mle(cfg, hists)
    if kind == "routed":
        return _routed_chat(cfg, hists[..., 0], chat), stddev * cfg.m, ok
    return chat, stddev, ok


def estimate_hist(cfg: SketchConfig, hist, *, kind: str = "full", solver: str = "newton"):
    """Ĉ from ONE full 2^b-bin histogram (bins sum to m)."""
    return _hists_with_ci_impl(cfg, hist, kind=kind, solver=solver)[0]


def estimate_hist_with_ci(cfg: SketchConfig, hist, *, kind: str = "full", solver: str = "newton"):
    """(Ĉ, stddev, converged) from ONE full histogram.

    kind="full": the MLE is Ĉ. kind="routed": Ĉ = m·MLE (0.0 exactly for an
    untouched row) and the stddev scales by the same m.
    """
    return _hists_with_ci_impl(cfg, hist, kind=kind, solver=solver)


def estimate_hists(cfg: SketchConfig, hists, *, kind: str = "full", solver: str = "newton"):
    """Ĉ[K] from full histograms ``int32[K, 2^b]``."""
    return _hists_with_ci_impl(cfg, hists, kind=kind, solver=solver)[0]


def estimate_hists_with_ci(cfg: SketchConfig, hists, *, kind: str = "full", solver: str = "newton"):
    """(Ĉ[K], stddev[K], converged[K]) from full histograms."""
    return _hists_with_ci_impl(cfg, hists, kind=kind, solver=solver)


def _rows_with_ci_impl(cfg: SketchConfig, regs, *, kind, solver):
    _check_kind(kind)
    _check_solver(solver)
    if solver == "fused":
        from ..kernels import ops  # deferred: kernels import core

        return ops.estimate_rows_op(cfg, regs, kind=kind)
    return _hists_with_ci_impl(
        cfg, estimators.histograms(cfg, regs), kind=kind, solver=solver
    )


def estimate_rows(cfg: SketchConfig, regs, *, kind: str = "routed", solver: str = "newton"):
    """Ĉ[K] from register rows ``int8[K, m]``."""
    return _rows_with_ci_impl(cfg, regs, kind=kind, solver=solver)[0]


def estimate_rows_with_ci(cfg: SketchConfig, regs, *, kind: str = "routed", solver: str = "newton"):
    """(Ĉ[K], stddev[K], converged[K]) from register rows ``int8[K, m]``.

    newton bincounts each row then solves; fused runs kernel K4 on a CUDA
    tensor (its plain version on a CPU tensor).
    """
    return _rows_with_ci_impl(cfg, regs, kind=kind, solver=solver)


# ---------------------------------------------------------------------------
# Pooled (virtual register sharing) solves
# ---------------------------------------------------------------------------


def pool_config(cfg: SketchConfig, pool_size: int) -> SketchConfig:
    """Pool-geometry config of a shared register pool: the same register
    family (b, hence r_min/r_max/num_bins/top_bin) with m = M pool slots.
    The pool plane of a ``VirtualDynArray`` is one routed-convention sketch
    of the whole tail stream: each element raises exactly one of M slots."""
    if pool_size <= cfg.m:
        raise ValueError(f"pool_size {pool_size} must exceed m {cfg.m} (alpha = m/M < 1)")
    return SketchConfig(m=pool_size, b=cfg.b, seed=cfg.seed)


# Nested log2(u) grid of the compound-Poisson profile solve: a coarse sweep
# of the whole representable octave range, then two refinements around the
# running argmax (final resolution 0.03125 octaves, about 2 % in u). A grid
# search, as in the JAX package: the mixture likelihood is multi-modal for
# near-empty rows and the solve must be deterministic across backends.
_VIRTUAL_GRID_STAGES = ((128, 2.0), (17, 0.25), (17, 0.03125))

# Largest float32 temporary of the batched solve, in bytes: the tenant axis
# is cut into chunks so that a [T, G, 2^b] block stays under it.
_VIRTUAL_CHUNK_BYTES = 1 << 30


def _virtual_loglik(cfg: SketchConfig, h, lam, log2_u):
    """Touched-bin log-likelihood of full histograms ``h`` [T, 2^b] under the
    compound-Poisson register law, for candidate log2(u) ``log2_u`` [T, G]
    (``lam`` [T]): -> [T, G].

    With per-slot element count N ~ Poisson(λ) of constant weight u,
    P(R <= v) = exp(-λ·(1 - e^{-u·s(v)})), s(v) = 2^{-(v+1)}. Bin 0 is the
    N = 0 mass e^{-λ}, constant in u, so it is omitted (it identifies λ).
    Evaluated via expm1 twice, as in the JAX package: g = -expm1(-u·s), and
    ln p_k = a_{k-1} + ln(expm1(a_k - a_{k-1})) with a_k = -λ·g_k.
    """
    k = torch.arange(cfg.num_bins, dtype=torch.float32, device=h.device)
    log2_s = -(k + cfg.r_min + 1.0)
    us = torch.exp2(log2_u[..., None] + log2_s)  # [T, G, bins]
    # g = -expm1(-u·s), as 1 - e^{-u·s} above 0.5 (what XLA's expm1
    # computes there): torch's vectorized CPU expm1f returns -1 below about
    # -16.64 instead of -17.33, which moves the likelihood's saturation
    # cliff (two touched bins at g = 1, da = 0) by a grid point.
    g = torch.where(us > 0.5, 1.0 - torch.exp(-us), -torch.expm1(-us))
    a = -lam[:, None, None] * g  # increasing in k, in [-λ, 0]
    da = a[..., 1:] - a[..., :-1]  # >= 0
    lnp = a[..., :-1] + torch.log(torch.expm1(torch.clamp(da, min=1e-30)))
    hk = h[:, None, 1:].to(torch.float32)
    return torch.where(hk > 0, hk * lnp, torch.zeros_like(lnp)).sum(-1)


def _virtual_hists_solve(cfg: SketchConfig, h):
    """Ŵ of each full histogram ``h`` [T, 2^b] via the compound-Poisson
    profile MLE: λ̂ = ln(m / T₀) from occupancy (T₀ clamped at 0.5, the
    linear-counting cap on saturated rows), û from the nested-grid profile
    likelihood over the touched bins (``torch.argmax`` takes the first
    maximum, as ``jnp.argmax`` does), Ŵ = m·λ̂·û; untouched rows read 0."""
    t0 = h[:, 0].to(torch.float32)
    # A true division (``m / tensor`` would multiply by a reciprocal).
    lam = torch.log(torch.full_like(t0, float(cfg.m)) / torch.clamp(t0, min=0.5))
    center = torch.zeros_like(t0)
    for npts, step in _VIRTUAL_GRID_STAGES:
        offs = (torch.arange(npts, dtype=torch.float32, device=h.device) - (npts - 1) / 2.0) * step
        grid = center[:, None] + offs
        ll = _virtual_loglik(cfg, h, lam, grid)
        center = grid.gather(1, ll.argmax(1, keepdim=True))[:, 0]
    u = torch.exp2(center)
    return torch.where(t0 >= cfg.m, torch.zeros_like(u), cfg.m * lam * u)


def _virtual_hists_impl(cfg: SketchConfig, hists, *, solver: str):
    """Compound-Poisson profile solve: Ĉ[K] from FULL histograms (the
    JAX package's ``_virtual_hists_impl`` has the derivation), over chunks
    of rows so that no temporary exceeds ``_VIRTUAL_CHUNK_BYTES``. The
    solve is a deterministic grid: "newton" is its only solver here."""
    _check_solver(solver, hists_input=True)
    g_max = max(npts for npts, _ in _VIRTUAL_GRID_STAGES)
    chunk = max(1, _VIRTUAL_CHUNK_BYTES // (g_max * cfg.num_bins * 4))
    if hists.shape[0] <= chunk:
        return _virtual_hists_solve(cfg, hists)
    return torch.cat([_virtual_hists_solve(cfg, hists[i : i + chunk])
                      for i in range(0, hists.shape[0], chunk)])


def estimate_hists_virtual(cfg: SketchConfig, hists, *, solver: str = "newton"):
    """Ĉ[K] from FULL histograms ``int32[K, 2^b]`` via the compound-Poisson
    profile solve — the light-load-safe read of the virtual tier.
    ``solver="fused"`` maps to newton (histogram input: nothing to fuse)."""
    solver = "newton" if solver == "fused" else solver
    return _virtual_hists_impl(cfg, hists, solver=solver)


def estimate_rows_virtual(cfg: SketchConfig, regs, *, solver: str = "newton"):
    """Ĉ[K] from register rows ``int8[K, m]`` via the compound-Poisson
    profile solve (bincount each row, then ``estimate_hists_virtual``): the
    read of register planes without martingales, such as the virtual tier's
    gathered tenant rows. ``solver="fused"`` maps to newton."""
    solver = "newton" if solver == "fused" else solver
    return _virtual_hists_impl(cfg, estimators.histograms(cfg, regs), solver=solver)


def estimate_pool_hist(cfg: SketchConfig, pool_hist, pool_size: int, *, solver: str = "newton"):
    """Ŵ_pool from the FULL pool histogram (bins sum to M): the virtual
    solve under the pool geometry (``pool_config``) — one O(2^b) read, the
    register-only cross-check of the exact ``w_tail`` accumulator.
    ``solver="fused"`` maps to newton."""
    _check_solver(solver)
    pcfg = pool_config(cfg, pool_size)
    return estimate_hists_virtual(pcfg, pool_hist[None, :], solver=solver)[0]


def cancel_pool_noise(cfg: SketchConfig, chat_virtual, chat_pool, pool_size: int):
    """Noise-cancellation pre-pass of the virtual-sketch estimate (Wang et
    al., arXiv 1811.09126; DESIGN.md §8.9): a tail tenant's m gathered pool
    registers see its own stream plus an ~α = m/M sample of everyone
    else's, so Ŵ_t = max(0, (Ŵ_v - α·W_pool) / (1 - α)). ``chat_pool``
    should be the exact ``w_tail`` accumulator. Broadcasts a batched
    ``chat_virtual`` against a scalar ``chat_pool``."""
    if pool_size <= cfg.m:
        raise ValueError(f"pool_size {pool_size} must exceed m {cfg.m} (alpha = m/M < 1)")
    alpha = torch.tensor(np.float32(cfg.m / pool_size), device=chat_virtual.device)
    cancelled = (chat_virtual - alpha * chat_pool) / (1.0 - alpha)
    return torch.clamp(cancelled, min=0.0)
