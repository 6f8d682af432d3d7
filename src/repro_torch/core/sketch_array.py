"""SketchArray: K independent QSketches updated from one keyed stream.

The port of ``repro/core/sketch_array.py``. An ``int8[K, m]`` register
matrix folds a whole keyed batch in one pass:

    y = quantized_values(cfg, ids, weights)   # (B, m), QSketch's own table
    R = R.at[keys].max(y)                     # segment scatter-max

Row k only ever receives elements with key k, and the key does not enter the
hash, so row k is bit-identical to a standalone QSketch fed the key-k
sub-stream: merge is element-wise max, estimation is the batched histogram
MLE (``kind="full"``: every element of a row feeds all m registers).

On a CUDA tensor ``update`` runs kernel K6 (``kernels/sketch_array_update.py``)
and changes the register matrix in place; on a CPU tensor it runs the
kernel's plain version, also in place.
"""

from __future__ import annotations

import torch

from . import estimation, estimators, hashing, key_directory, qsketch
from .types import QSketchState, SketchArrayState, SketchConfig, resolve_device


def init(cfg: SketchConfig, k: int, device="cuda") -> SketchArrayState:
    """K fresh sketches on ``device``; K is carried by the state's shape."""
    if k < 1:
        raise ValueError("SketchArray needs k >= 1 sketches")
    dev = resolve_device(device)
    return SketchArrayState(regs=torch.full((k, cfg.m), cfg.r_min, dtype=torch.int8, device=dev))


def num_sketches(state: SketchArrayState) -> int:
    """Tenant capacity K (the register matrix's row count)."""
    return state.regs.shape[0]


def row(state: SketchArrayState, k: int) -> QSketchState:
    """Sketch k as a standalone QSketchState (a view of row k). ``k`` must
    be an int in [0, K); out-of-range indices raise instead of wrapping."""
    n = state.regs.shape[0]
    if not 0 <= k < n:
        raise IndexError(f"sketch row {k} out of range for K={n}")
    return QSketchState(regs=state.regs[k])


def update(cfg: SketchConfig, state: SketchArrayState, keys, ids, weights, mask=None) -> SketchArrayState:
    """One fused pass over a keyed batch: R <- R.at[keys].max(y), in place.

    keys: int[B] routing each element to its sketch row; out-of-range keys
      are clipped to [0, K) (callers pad with key 0 + mask=False).
    mask: optional bool[B]; False rows contribute r_min everywhere (no-ops):
      they enter as log2 w = -inf, as in ``qsketch.update``.
    Returns ``state`` (its register matrix updated in place).
    """
    from ..kernels import ops  # deferred: kernels import core

    lo, hi = hashing.split_id64(ids)
    log2w = torch.log2(weights.to(torch.float32))
    if mask is not None:
        log2w = torch.where(mask, log2w, torch.full_like(log2w, float("-inf")))
    keys = torch.clamp(keys.to(torch.int64), 0, state.regs.shape[0] - 1)
    ops.sketch_array_update_op(
        cfg, state.regs, keys.contiguous(), lo.contiguous(), hi.contiguous(), log2w.contiguous()
    )
    return state


def histograms(cfg: SketchConfig, state: SketchArrayState) -> torch.Tensor:
    """Per-sketch register histograms, int32[K, 2^b]."""
    return estimators.histograms(cfg, state.regs)


def estimate_all(cfg: SketchConfig, state: SketchArrayState, *, solver: str = "newton") -> torch.Tensor:
    """Ĉ for every sketch: one batched histogram MLE."""
    return estimate_all_with_ci(cfg, state, solver=solver)[0]


def estimate_all_with_ci(cfg: SketchConfig, state: SketchArrayState, *, solver: str = "newton"):
    """(Ĉ[K], stddev[K], converged[K]): the full-kind histogram MLE of every
    row (``estimation.estimate_hists``)."""
    return estimation.estimate_hists_with_ci(cfg, histograms(cfg, state), kind="full", solver=solver)


def merge(a: SketchArrayState, b: SketchArrayState) -> SketchArrayState:
    """Row-wise union merge (max monoid). Shapes must agree exactly: a
    (K, m) mismatch means the operands are not sketches of one tenant
    space, and broadcasting would cross-contaminate rows."""
    if a.regs.shape != b.regs.shape:
        raise ValueError(
            f"SketchArray merge needs matching (K, m), got {tuple(a.regs.shape)} vs {tuple(b.regs.shape)}"
        )
    return SketchArrayState(regs=torch.maximum(a.regs, b.regs))


def update_tenants(
    cfg: SketchConfig,
    dcfg: key_directory.DirectoryConfig,
    state: SketchArrayState,
    dir_state: key_directory.DirectoryState,
    tenant_keys,
    ids,
    weights,
    mask=None,
):
    """Sparse-tenant entry: route 64-bit tenant ids through the key
    directory, then run the fused keyed update. Returns (state, directory
    telemetry); both are updated in place."""
    if dcfg.capacity != state.regs.shape[0]:
        raise ValueError(
            f"directory capacity {dcfg.capacity} != SketchArray rows {state.regs.shape[0]}"
        )
    slots, dir_state = key_directory.route(dcfg, dir_state, tenant_keys, mask=mask)
    return update(cfg, state, slots, ids, weights, mask=mask), dir_state


def update_reference(cfg: SketchConfig, state: SketchArrayState, keys, ids, weights, mask=None) -> SketchArrayState:
    """Oracle: partition the stream by key and run K independent
    single-sketch updates. O(K) dispatches — tests only, never the hot path.
    Keys outside [0, K) and masked rows are dropped from every sub-stream.
    Returns a new state; ``state`` is not changed."""
    live = torch.ones(keys.shape, dtype=torch.bool, device=keys.device) if mask is None else mask
    lo, hi = hashing.split_id64(ids)
    rows = []
    for k in range(state.regs.shape[0]):
        st = QSketchState(regs=state.regs[k])
        sel = (keys == k) & live
        if bool(sel.any()):
            st = qsketch.update(cfg, st, (lo[sel], hi[sel]), weights[sel])
        rows.append(st.regs)
    return SketchArrayState(regs=torch.stack(rows))
