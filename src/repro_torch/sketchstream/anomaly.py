"""AnomalyBank: per-tenant drift scoring over windowed sketch estimates.

The port of ``repro/sketchstream/anomaly.py``. It consumes the per-tenant
weighted-cardinality vector a ``WindowMonitor`` emits every step and keeps,
per tenant:

* an **EWMA baseline** of the estimate and of its absolute deviation (the
  tenant's normal windowed traffic and its noise scale);
* a **one-sided CUSUM** drift score over the standardized residual,
  s_t = max(0, s_{t-1} + z_t - k).

``step`` is a handful of elementwise tensor ops over all K tenants (no
kernel). Alerting semantics, as in the JAX package: the first ``warmup``
steps only adapt the baseline (running mean) and never score; tenants whose
baseline is below ``min_weight`` never score; while a tenant's score is over
the threshold ``h`` its baseline adapts at ``alpha * freeze_factor``.
``top_alerts`` ranks the alerting tenants on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import resolve_device


@dataclasses.dataclass(frozen=True)
class AnomalyConfig:
    """Frozen scoring config.

    Attributes:
      alpha: EWMA step for the baseline mean/deviation (post-warmup).
      cusum_k: CUSUM slack in deviation units.
      cusum_h: alert threshold; a tenant alerts while score > cusum_h.
      warmup: steps of baseline-only adaptation before scoring starts (for
        sliding-window feeds, cover the ring fill: warmup >= E).
      min_weight: tenants whose baseline is below this never score.
      min_scale: absolute floor on the deviation scale.
      freeze_factor: baseline-adaptation multiplier while over threshold,
        in [0, 1).
    """

    alpha: float = 0.2
    cusum_k: float = 0.5
    cusum_h: float = 6.0
    warmup: int = 3
    min_weight: float = 1.0
    min_scale: float = 1e-3
    freeze_factor: float = 0.1

    def __post_init__(self):
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError("EWMA alpha must be in (0, 1]")
        if self.cusum_h <= 0 or self.cusum_k < 0:
            raise ValueError("need cusum_h > 0 and cusum_k >= 0")
        if self.warmup < 1:
            raise ValueError("warmup must be >= 1 (the first observation has no baseline)")
        if not 0.0 <= self.freeze_factor < 1.0:
            raise ValueError("freeze_factor must be in [0, 1)")


class AnomalyBankState(NamedTuple):
    """Per-tenant scoring state."""

    mean: torch.Tensor  # f32[K] EWMA baseline of the windowed estimate
    dev: torch.Tensor  # f32[K] EWMA of |residual| (noise scale)
    score: torch.Tensor  # f32[K] one-sided CUSUM drift score
    n_steps: torch.Tensor  # int32 scalar, observations folded so far


def init(k: int, device="cuda") -> AnomalyBankState:
    """Fresh bank for K tenants on ``device``: zero baselines and scores."""
    if k < 1:
        raise ValueError("AnomalyBank needs k >= 1 tenants")
    dev = resolve_device(device)
    zeros = lambda: torch.zeros((k,), dtype=torch.float32, device=dev)  # noqa: E731
    return AnomalyBankState(
        mean=zeros(), dev=zeros(), score=zeros(),
        n_steps=torch.zeros((), dtype=torch.int32, device=dev),
    )


def step(bcfg: AnomalyConfig, state: AnomalyBankState, estimates):
    """Fold one observation vector Ĉ[K]; -> (state', scores f32[K]).

    Scores are in threshold units: score > cusum_h means alerting. During
    warmup every score is 0 and the baseline is a running mean (step t
    weights the new observation 1/(t+1)); afterwards mean/dev follow the
    EWMA, damped to ``freeze_factor * alpha`` for tenants over threshold
    after this step's scoring. Returns a new state.
    """
    est = torch.as_tensor(estimates, dtype=torch.float32, device=state.mean.device)
    in_warmup = state.n_steps < bcfg.warmup

    resid = est - state.mean
    scale = torch.clamp(state.dev, min=bcfg.min_scale)
    z = resid / scale
    scored = (~in_warmup) & (state.mean >= bcfg.min_weight)
    score = torch.where(scored, torch.clamp(state.score + z - bcfg.cusum_k, min=0.0), 0.0)

    eff_alpha = torch.where(
        in_warmup,
        1.0 / (state.n_steps.to(torch.float32) + 1.0),
        torch.tensor(bcfg.alpha, dtype=torch.float32, device=est.device),
    )
    adapt = torch.where(score > bcfg.cusum_h, bcfg.freeze_factor * eff_alpha, eff_alpha)
    mean = state.mean + adapt * resid
    dev = state.dev + adapt * (torch.abs(resid) - state.dev)
    return AnomalyBankState(mean=mean, dev=dev, score=score, n_steps=state.n_steps + 1), score


def merge(a: AnomalyBankState, b: AnomalyBankState) -> AnomalyBankState:
    """Union of banks scoring DISJOINT tenant rows: element-wise sums of
    baselines and scores are exact when each tenant is live on one pod
    only. Banks that scored the same tenant must not be merged."""
    if a.mean.shape != b.mean.shape:
        raise ValueError(
            f"AnomalyBank merge needs matching K, got {tuple(a.mean.shape)} vs {tuple(b.mean.shape)}"
        )
    return AnomalyBankState(
        mean=a.mean + b.mean,
        dev=a.dev + b.dev,
        score=a.score + b.score,
        n_steps=torch.maximum(a.n_steps, b.n_steps),
    )


def top_alerts(bcfg: AnomalyConfig, scores, n: int = 5):
    """Host-side ranked alert set: [(slot, score), ...] for the up-to-n
    tenants whose score exceeds the threshold, strongest first."""
    s = scores.detach().cpu().numpy() if isinstance(scores, torch.Tensor) else np.asarray(scores)
    over = np.nonzero(s > bcfg.cusum_h)[0]
    ranked = over[np.argsort(-s[over], kind="stable")][: int(n)]
    return [(int(i), float(s[i])) for i in ranked]
