"""WindowArray: sliding-window weighted cardinality over K tenants.

The port of ``repro/core/window_array.py``. State (``WindowArrayState``):
an ``int8[E, K, m]`` ring of epoch register planes with per-epoch DynArray
histograms and chats, a ``head`` ring pointer, and a cached union sub-state
(max over all E epochs, with DynArray histogram and martingale maintenance
on top).

* ``update_batch`` folds a keyed batch into the CURRENT epoch: the DynArray
  update tail runs twice on the same elements, on the head epoch plane and
  on the union, each with its q_R from kernel K3 against that sub-state's
  batch-start histograms.
* ``rotate`` closes the current epoch: advance ``head``, reset the slot it
  lands on (evicting the oldest epoch once the ring is full), rebuild the
  union from the surviving planes and re-base the union martingales to the
  union's histogram MLE.
* ``estimate_window(w)`` reads "weighted cardinality over the last w <= E
  epochs": the full histogram of the union of the w newest planes (kernel
  K7 on a CUDA tensor), then the histogram MLE. The full-ring window reads
  the cached ``union_hists`` instead.
* ``estimate_ring_anytime`` is the O(K) read of the running union
  martingales, which anomaly scoring consumes.

In place: ``update_batch`` and ``rotate`` change the state's tensors in
place (the ring scalars too) and return the same state. The head plane is
addressed on the device — the ring is viewed as E*K DynArray rows and the
batch's keys are offset by head*K — so an update never reads ``head`` on
the host and never writes into a copy of the plane.
"""

from __future__ import annotations

import torch

from . import dyn_array, hashing, key_directory, qsketch_dyn
from .types import DynArrayState, SketchConfig, WindowArrayState, resolve_device


def init(cfg: SketchConfig, k: int, e: int, device="cuda") -> WindowArrayState:
    """K tenants x E ring epochs on ``device``; epoch 0 is the current one."""
    if k < 1:
        raise ValueError("WindowArray needs k >= 1 sketches")
    if e < 2:
        raise ValueError("WindowArray needs e >= 2 epochs (e == 1 is a DynArray)")
    dev = resolve_device(device)
    scalar = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    return WindowArrayState(
        regs=torch.full((e, k, cfg.m), cfg.r_min, dtype=torch.int8, device=dev),
        hists=torch.zeros((e, k, cfg.num_bins), dtype=torch.int32, device=dev),
        chats=torch.zeros((e, k), dtype=torch.float32, device=dev),
        union_regs=torch.full((k, cfg.m), cfg.r_min, dtype=torch.int8, device=dev),
        union_hists=torch.zeros((k, cfg.num_bins), dtype=torch.int32, device=dev),
        union_chats=torch.zeros((k,), dtype=torch.float32, device=dev),
        head=scalar(0),
        filled=scalar(1),
        epoch_id=scalar(0),
    )


def num_epochs(state: WindowArrayState) -> int:
    """Ring size E."""
    return state.regs.shape[0]


def num_sketches(state: WindowArrayState) -> int:
    """Tenant capacity K."""
    return state.regs.shape[1]


def epoch_substate(state: WindowArrayState, e: int) -> DynArrayState:
    """Epoch slot ``e`` (a host int) as a DynArray of views into the ring."""
    return DynArrayState(regs=state.regs[e], hists=state.hists[e], chats=state.chats[e])


def union_substate(state: WindowArrayState) -> DynArrayState:
    """The cached full-ring union as a DynArray (the state's own tensors)."""
    return DynArrayState(regs=state.union_regs, hists=state.union_hists, chats=state.union_chats)


def _ring_rows(state: WindowArrayState) -> DynArrayState:
    """The whole ring as one DynArray of E*K rows (views, no copy)."""
    e, k, m = state.regs.shape
    return DynArrayState(
        regs=state.regs.view(e * k, m),
        hists=state.hists.view(e * k, -1),
        chats=state.chats.view(e * k),
    )


def _apply_update(cfg: SketchConfig, state: WindowArrayState, keys, lo, hi, w, live):
    """The update's tail on the head epoch plane and on the union, in place.
    ``keys`` are in-range rows (int64) and ``live`` the final element mask."""
    from ..kernels import ops  # deferred: kernels import core

    k = state.regs.shape[1]
    ring = _ring_rows(state)
    ep_keys = keys + state.head.to(torch.int64) * k
    q_ep = ops.dyn_array_update_op(cfg, ring.hists, ep_keys, w)
    dyn_array._apply_update(cfg, ring, ep_keys, lo, hi, w, live, q_ep)

    un = union_substate(state)
    q_un = ops.dyn_array_update_op(cfg, un.hists, keys, w)
    dyn_array._apply_update(cfg, un, keys, lo, hi, w, live, q_un)
    return state


def update_batch(cfg: SketchConfig, state: WindowArrayState, keys, ids, weights, mask=None) -> WindowArrayState:
    """Fold one keyed batch into the current epoch and the union cache, in
    place; returns ``state``.

    Same contract as ``dyn_array.update_batch`` (keys clipped to [0, K),
    masked and degenerate-weight rows dropped before dedup). The head plane
    stays bit-identical to a standalone DynArray fed this epoch's
    sub-stream; the union advances the full-ring anytime martingale against
    the union's batch-start state. The union invariant (union == max over
    epochs) holds exactly: an element raises union[k, j] iff its y exceeds
    the union register, which dominates the epoch register it also raises.
    """
    k = state.regs.shape[1]
    lo, hi = hashing.split_id64(ids)
    w = weights.to(torch.float32).contiguous()
    keys = torch.clamp(keys.to(torch.int64), 0, k - 1).contiguous()
    live = qsketch_dyn._live_weight_mask(w, mask)
    return _apply_update(cfg, state, keys, lo, hi, w, live)


def _chats_from_touched_hists(cfg: SketchConfig, hists, solver: str = "newton") -> torch.Tensor:
    """Per-row MLE Ĉ from touched-register histograms (bin 0 pinned to 0):
    fill bin 0 with the untouched count and run the histogram MLE."""
    full = hists.clone()
    full[:, 0] = cfg.m - hists.sum(1, dtype=torch.int32)
    return dyn_array.estimate_mle_hists(cfg, full, solver=solver)


def rotate(cfg: SketchConfig, state: WindowArrayState) -> WindowArrayState:
    """Close the current epoch and open the next ring slot, in place.

    Advance ``head`` and reset the slot it lands on — once the ring is full
    that slot holds the OLDEST epoch, which is thereby evicted. Then rebuild
    the union cache from the surviving planes and re-base the union
    martingales to the MLE of the surviving union (eviction can lower the
    union, which no running martingale can track). ``filled`` grows to E;
    ``epoch_id`` advances by one. Returns ``state``.
    """
    e = state.regs.shape[0]
    state.head.add_(1).remainder_(e)
    slot = state.head.to(torch.int64).view(1)
    state.regs.index_fill_(0, slot, cfg.r_min)
    state.hists.index_fill_(0, slot, 0)
    state.chats.index_fill_(0, slot, 0.0)
    state.union_regs.copy_(torch.amax(state.regs, dim=0))
    state.union_hists.copy_(dyn_array.rebuild_hists(cfg, state.union_regs))
    state.union_chats.copy_(_chats_from_touched_hists(cfg, state.union_hists))
    state.filled.add_(1).clamp_(max=e)
    state.epoch_id.add_(1)
    return state


def _window_slots(state: WindowArrayState, w: int) -> torch.Tensor:
    """Ring slots of the last w epochs, newest first: head, head-1, ..."""
    e = state.regs.shape[0]
    ages = torch.arange(w, dtype=torch.int64, device=state.regs.device)
    return torch.remainder(state.head.to(torch.int64) - ages, e)


def window_union_regs(state: WindowArrayState, w: int) -> torch.Tensor:
    """Exact union registers of the last w epochs, int8[K, m] (gathers the
    [w, K, m] planes; the windowed read streams them through K7 instead)."""
    return torch.amax(state.regs[_window_slots(state, w)], dim=0)


def _check_w(state: WindowArrayState, w: int) -> int:
    e = state.regs.shape[0]
    w = int(w)
    if not 1 <= w <= e:
        raise ValueError(f"window w={w} out of range [1, E={e}]")
    return w


def estimate_window(cfg: SketchConfig, state: WindowArrayState, w: int, *, solver: str = "newton") -> torch.Tensor:
    """Ĉ[K] over the last w <= E epochs (w a host int).

    Sub-ring windows: the full histograms of the union of the w newest
    planes (kernel K7 on a CUDA tensor, its plain version on a CPU tensor),
    then the histogram MLE — the same integer histograms on both paths, so
    the two agree bit for bit. The full-ring window reads the cached union
    histograms. Epochs beyond ``filled`` hold r_min everywhere, so w >
    filled clamps harmlessly; untouched windows report Ĉ = 0.
    """
    from ..kernels import ops  # deferred: kernels import core

    w = _check_w(state, w)
    if w == state.regs.shape[0]:
        return _chats_from_touched_hists(cfg, state.union_hists, solver=solver)
    hists = ops.window_union_op(cfg, state.regs, state.head, w)
    return dyn_array.estimate_mle_hists(cfg, hists, solver=solver)


def estimate_ring_anytime(state: WindowArrayState) -> torch.Tensor:
    """O(K) anytime read of the full-ring window: the running union
    martingales (re-based to the union MLE at every rotation)."""
    return state.union_chats


def estimate_epochs_all(cfg: SketchConfig, state: WindowArrayState, *, solver: str = "newton") -> torch.Tensor:
    """Per-epoch MLE re-estimates, Ĉ[E, K] (E independent solves; the
    per-epoch anytime reads are ``state.chats``)."""
    e, k, m = state.regs.shape
    return dyn_array.estimate_mle_rows(cfg, state.regs.reshape(e * k, m), solver=solver).reshape(e, k)


def update_tenants(
    cfg: SketchConfig,
    dcfg: key_directory.DirectoryConfig,
    state: WindowArrayState,
    dir_state: key_directory.DirectoryState,
    tenant_keys,
    ids,
    weights,
    mask=None,
):
    """Sparse-tenant entry: route 64-bit tenant ids through the key
    directory, stamping each routed slot with the window's ``epoch_id``
    (read on the device), then run the keyed update. Returns (state,
    directory telemetry); both are updated in place."""
    if dcfg.capacity != state.regs.shape[1]:
        raise ValueError(
            f"directory capacity {dcfg.capacity} != WindowArray rows {state.regs.shape[1]}"
        )
    slots, dir_state = key_directory.route(dcfg, dir_state, tenant_keys, mask=mask, epoch=state.epoch_id)
    return update_batch(cfg, state, slots, ids, weights, mask=mask), dir_state


def check_ring_aligned(a: WindowArrayState, b: WindowArrayState) -> None:
    """Two windows combine only with matching geometry and an aligned ring
    clock (reads the ring scalars on the host)."""
    if a.regs.shape != b.regs.shape:
        raise ValueError(
            f"WindowArray merge needs matching (E, K, m), got {tuple(a.regs.shape)} vs {tuple(b.regs.shape)}"
        )
    if (int(a.head), int(a.filled), int(a.epoch_id)) != (int(b.head), int(b.filled), int(b.epoch_id)):
        raise ValueError(
            "WindowArray merge needs ring-aligned states (same head/filled/"
            "epoch_id): pods must rotate on a shared clock"
        )


def merge(cfg: SketchConfig, a: WindowArrayState, b: WindowArrayState) -> WindowArrayState:
    """Cross-pod merge of ring-ALIGNED windows: per-epoch register max,
    histograms rebuilt, chats re-estimated by the MLE (running martingales
    are not additive across pods that may share elements), union cache
    rebuilt from the merged epochs. Returns a new state."""
    check_ring_aligned(a, b)
    e, k, m = a.regs.shape
    regs = torch.maximum(a.regs, b.regs)
    flat_hists = dyn_array.rebuild_hists(cfg, regs.reshape(e * k, m))
    union_regs = torch.amax(regs, dim=0)
    union_hists = dyn_array.rebuild_hists(cfg, union_regs)
    return WindowArrayState(
        regs=regs,
        hists=flat_hists.reshape(e, k, cfg.num_bins),
        chats=_chats_from_touched_hists(cfg, flat_hists).reshape(e, k),
        union_regs=union_regs,
        union_hists=union_hists,
        union_chats=_chats_from_touched_hists(cfg, union_hists),
        head=a.head.clone(),
        filled=a.filled.clone(),
        epoch_id=a.epoch_id.clone(),
    )


def update_reference(cfg: SketchConfig, state: WindowArrayState, keys, ids, weights, mask=None) -> WindowArrayState:
    """Oracle: the K-loop ``dyn_array.update_reference`` applied to the head
    epoch AND the union sub-state. Tests only. Returns a new state."""
    head = int(state.head)
    ep = dyn_array.update_reference(cfg, epoch_substate(state, head), keys, ids, weights, mask=mask)
    un = dyn_array.update_reference(cfg, union_substate(state), keys, ids, weights, mask=mask)
    regs, hists, chats = state.regs.clone(), state.hists.clone(), state.chats.clone()
    regs[head], hists[head], chats[head] = ep.regs, ep.hists, ep.chats
    return WindowArrayState(
        regs=regs, hists=hists, chats=chats,
        union_regs=un.regs, union_hists=un.hists, union_chats=un.chats,
        head=state.head.clone(), filled=state.filled.clone(), epoch_id=state.epoch_id.clone(),
    )

