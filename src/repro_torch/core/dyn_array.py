"""DynArray: K independent QSketch-Dyn sketches with O(1)-anytime reads.

State (``DynArrayState``): ``int8[K, m]`` registers + ``int32[K, 2^b]``
touched-register histograms + ``float32[K]`` running estimates. Row k is
bit-identical to a standalone ``DynState`` fed the key-k sub-stream: the
register choice g(x) and quantized value y(x, w) never see the key, dedup is
per (key, id), and each element's update probability q_R comes from ITS
key's batch-start histogram (Eq. 12 semantics per row).

The update: q_R of every element runs in kernel K3 on a CUDA tensor (its
plain version on a CPU tensor); the tail — keyed dedup, register
scatter-max, incremental histogram moves and the martingale add — is
PyTorch ops, as the JAX package leaves it to XLA. The JAX package splits
the update into a read-only plan and a scatter-only commit so that XLA can
alias donated buffers; PyTorch updates in place, so here the update simply
gathers what it needs first and then writes ``state``'s tensors in place.
Only the output bits must match the JAX package's.

Keyed martingale semantics (DESIGN.md §8.4): per-key chats are additive
across disjoint batches of one stream, but NOT across shards that may have
seen the same element — ``merge`` max-merges registers and re-estimates
every chat with the per-key histogram MLE.
"""

from __future__ import annotations

import torch

from . import estimation, estimators, hashing, key_directory, qsketch_dyn
from .types import DynArrayState, DynState, SketchConfig, resolve_device


def init(cfg: SketchConfig, k: int, device="cuda") -> DynArrayState:
    """K fresh Dyn sketches on ``device``."""
    if k < 1:
        raise ValueError("DynArray needs k >= 1 sketches")
    dev = resolve_device(device)
    return DynArrayState(
        regs=torch.full((k, cfg.m), cfg.r_min, dtype=torch.int8, device=dev),
        hists=torch.zeros((k, cfg.num_bins), dtype=torch.int32, device=dev),
        chats=torch.zeros((k,), dtype=torch.float32, device=dev),
    )


def _apply_update(cfg: SketchConfig, state: DynArrayState, keys, lo, hi, w, live, q):
    """The update's tail, in place: dedup, change indicators, register
    scatter-max, histogram moves, martingale add. ``q`` is each element's
    update probability from its key's batch-start histogram."""
    m, nb = cfg.m, cfg.num_bins
    j, y = qsketch_dyn._choose_and_quantize(cfg, lo, hi, w)
    alive = qsketch_dyn.first_live_occurrence(keys, lo, hi, live) & live
    cell = keys * m + j  # flat register index
    regs_flat = state.regs.view(-1)
    old = regs_flat[cell].to(torch.int32)
    changed = alive & (y > old)
    chat_add = torch.where(changed, w / q, torch.zeros_like(w))
    y_eff = torch.where(changed, y, torch.full_like(y, cfg.r_min))

    # Each register the batch changed moves one unit of histogram mass
    # old-bin -> final-bin, counted once per (key, register). ``final`` is
    # the group max of y_eff floored by ``old`` — exactly the value the
    # scatter-max leaves there.
    order = torch.sort(cell).indices
    s_cell = cell[order]
    starts = torch.ones_like(live)
    starts[1:] = s_cell[1:] != s_cell[:-1]
    seg = torch.cumsum(starts, 0) - 1
    smax = torch.full_like(y_eff, cfg.r_min).scatter_reduce_(0, seg, y_eff[order], "amax")
    final_sorted = torch.maximum(old[order], smax[seg])
    final = torch.empty_like(final_sorted)
    final[order] = final_sorted
    reg_first = torch.empty_like(starts)
    reg_first[order] = starts
    reg_changed = reg_first & (final > old)
    dec = reg_changed & (old > cfg.r_min)  # old at r_min was never tracked

    # Commit. Every row of a (key, register) group writes the same final
    # value, so the duplicate writes agree.
    regs_flat[cell] = final.to(torch.int8)
    hists_flat = state.hists.view(-1)
    hists_flat.index_add_(0, keys * nb + (old - cfg.r_min), -dec.to(torch.int32))
    hists_flat.index_add_(0, keys * nb + (final - cfg.r_min), reg_changed.to(torch.int32))
    state.chats.index_add_(0, keys, chat_add)
    return state


def update_batch(cfg: SketchConfig, state: DynArrayState, keys, ids, weights, mask=None) -> DynArrayState:
    """One fused keyed batch, batch-stale per row; updates ``state`` in
    place and returns it.

    keys: int[B] in [0, K) routing each element to its sketch row;
      out-of-range keys are clipped (callers pad with key 0 + mask=False).
    mask: optional bool[B]; masked rows and degenerate (non-positive /
      non-finite) weights are dropped before dedup — they neither shadow a
      live duplicate nor enter the martingale.
    """
    from ..kernels import ops  # deferred: kernels import core

    k = state.regs.shape[0]
    lo, hi = hashing.split_id64(ids)
    w = weights.to(torch.float32).contiguous()
    keys = torch.clamp(keys.to(torch.int64), 0, k - 1).contiguous()
    live = qsketch_dyn._live_weight_mask(w, mask)
    q = ops.dyn_array_update_op(cfg, state.hists, keys, w)
    return _apply_update(cfg, state, keys, lo, hi, w, live, q)


def rebuild_hists(cfg: SketchConfig, regs) -> torch.Tensor:
    """Per-key touched-register histograms from scratch (bin 0 pinned to 0)."""
    hists = estimators.histograms(cfg, regs)
    hists[:, 0] = 0
    return hists


def estimate_all(state: DynArrayState) -> torch.Tensor:
    """Ĉ for every sketch: a pure O(K) read of the running martingales."""
    return state.chats


def estimate_mle_rows(cfg: SketchConfig, regs, *, solver: str = "newton") -> torch.Tensor:
    """Per-row histogram-MLE Ĉ (routed: ×m, untouched rows 0) from an
    ``int8[K, m]`` register matrix."""
    return estimation.estimate_rows(cfg, regs, kind="routed", solver=solver)


def estimate_mle_hists(cfg: SketchConfig, full_hists, *, solver: str = "newton") -> torch.Tensor:
    """Per-row histogram-MLE Ĉ (routed) from FULL histograms
    ``int32[K, 2^b]`` (bin 0 counts untouched r_min registers, rows sum to
    m). Equal to ``estimate_mle_rows`` on the registers the histograms were
    counted from: the likelihood sees registers only through their
    histogram, which lets the window array read its cached union histograms
    without walking the registers."""
    return estimation.estimate_hists(cfg, full_hists, kind="routed", solver=solver)


def estimate_mle_all(cfg: SketchConfig, state: DynArrayState, *, solver: str = "newton") -> torch.Tensor:
    """Per-key histogram-MLE re-estimate, Ĉ[K]. ``solver="fused"`` streams
    the registers through kernel K4 on a CUDA tensor."""
    return estimation.estimate_rows(cfg, state.regs, kind="routed", solver=solver)


def merge(cfg: SketchConfig, a: DynArrayState, b: DynArrayState) -> DynArrayState:
    """Merge two fleets sketching (possibly overlapping) sub-streams: row-wise
    register max, rebuilt histograms, chats re-estimated per key by the
    histogram MLE (running martingales are not additive across shards)."""
    if a.regs.shape != b.regs.shape:
        raise ValueError(
            f"DynArray merge needs matching (K, m), got {tuple(a.regs.shape)} vs {tuple(b.regs.shape)}"
        )
    regs = torch.maximum(a.regs, b.regs)
    return DynArrayState(
        regs=regs, hists=rebuild_hists(cfg, regs), chats=estimate_mle_rows(cfg, regs)
    )


def update_tenants(
    cfg: SketchConfig,
    dcfg: key_directory.DirectoryConfig,
    state: DynArrayState,
    dir_state: key_directory.DirectoryState,
    tenant_keys,
    ids,
    weights,
    mask=None,
):
    """Sparse-tenant entry: route 64-bit tenant ids through the key directory,
    then run the fused keyed update. Returns (state, directory telemetry);
    both are updated in place."""
    if dcfg.capacity != state.regs.shape[0]:
        raise ValueError(
            f"directory capacity {dcfg.capacity} != DynArray rows {state.regs.shape[0]}"
        )
    slots, dir_state = key_directory.route(dcfg, dir_state, tenant_keys, mask=mask)
    return update_batch(cfg, state, slots, ids, weights, mask=mask), dir_state


def update_reference(cfg: SketchConfig, state: DynArrayState, keys, ids, weights, mask=None) -> DynArrayState:
    """Oracle: partition the stream by key (order kept) and run K independent
    ``qsketch_dyn.update_batch`` calls. O(K) dispatches — tests only, never
    the hot path. Keys are clipped to [0, K); masked rows are dropped from
    their key's sub-stream. Returns a new state; ``state`` is not changed."""
    k = state.regs.shape[0]
    keys = torch.clamp(keys.to(torch.int64), 0, k - 1)
    live = torch.ones(keys.shape, dtype=torch.bool, device=keys.device) if mask is None else mask
    lo, hi = hashing.split_id64(ids)
    w = weights.to(torch.float32)
    rows = []
    for r in range(k):
        st = DynState(regs=state.regs[r], hist=state.hists[r], chat=state.chats[r])
        sel = (keys == r) & live
        if bool(sel.any()):
            st = qsketch_dyn.update_batch(cfg, st, (lo[sel], hi[sel]), w[sel])
        rows.append(st)
    return DynArrayState(
        regs=torch.stack([r.regs for r in rows]),
        hists=torch.stack([r.hist for r in rows]),
        chats=torch.stack([r.chat for r in rows]),
    )
