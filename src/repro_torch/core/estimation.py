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

Scaling conventions (``kind=``): ``"full"`` — every element feeds all m
registers (QSketch, the in-step monitor); the MLE *is* Ĉ. ``"routed"`` —
one register per element (Dyn rows); Ĉ = m·MLE, and untouched rows
(full-histogram bin 0 == m) report exactly 0.0.

Tolerance semantics: ``fused`` matches the float64 reference MLE within
``LUT_RTOL`` relative error or ``ATOL_FLOOR`` absolute.
"""

from __future__ import annotations

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
