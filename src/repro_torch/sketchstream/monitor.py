"""Stream telemetry monitors: the ported surfaces of
``repro/sketchstream/monitor.py``.

* The scalar monitor (``MonitorState``, ``init`` / ``update`` /
  ``estimate`` / ``merge``): one FULL QSketch — every element updates all m
  registers (kernel K1 on the card) — plus an occurrence counter. Full
  QSketch rather than Dyn because its registers are a plain max monoid:
  merging monitors that saw the same elements is exact (DESIGN.md §4.3).
* The per-key monitor (``ArrayMonitorState``, ``init_array`` /
  ``update_array`` / ``estimate_array`` / ``merge_array``): K full
  QSketches in one register matrix (``core/sketch_array.py``, kernel K6 on
  the card); keys are dense slots, or sparse 64-bit ids routed statelessly
  through the key directory when ``dcfg`` is given.
* ``DynArrayMonitor``: per-tenant weighted cardinality with O(1)-anytime
  reads — sparse 64-bit tenant ids through the key directory into a
  DynArray whose per-key martingales make ``estimate`` a pure O(K) read.
* ``VirtualDynMonitor``: the same sparse-key surface where pinned hot
  tenants keep dense rows and the long tail shares one register pool
  (``core/virtual_dyn_array.py``, kernels K8 and K3 on the card).
* ``WindowMonitor``: the same sparse-key surface over an epoch ring
  (``core/window_array.py``): estimates answer "weighted distinct traffic
  in the last w <= E epochs"; ``rotate`` advances the epoch clock and ages
  cold directory slots; the windowed MLE read runs kernel K7 on the card.

``tenant_metrics`` / ``directory_metrics`` publish the tenant surface's
scalars to the port's metrics registry (``obs/metrics.py``).

Padding: ``update`` takes an optional boolean ``mask`` (same leading shape
as ``ids``); masked-off rows neither touch the sketch nor count toward
``n_seen``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import (
    dyn_array, estimation, estimators, key_directory, qsketch, sketch_array, virtual_dyn_array,
    window_array,
)
from ..core.key_directory import DirectoryConfig, DirectoryState
from ..core.types import (
    DynArrayState, QSketchState, SketchArrayState, SketchConfig, VirtualDynArrayState,
    WindowArrayState, resolve_device,
)
from ..core.virtual_dyn_array import VirtualConfig
from ..obs import metrics as obs_metrics

_M_TENANT_SEEN = obs_metrics.gauge(
    "tenant_elements_seen", "live elements folded across all tenants",
    labels=("monitor",))
_M_TENANT_SLOTS = obs_metrics.gauge(
    "tenant_slots_claimed", "directory slots holding a fingerprint",
    labels=("monitor",))
_M_TENANT_COLLISIONS = obs_metrics.gauge(
    "tenant_collision_rate", "fraction of routed elements that collided",
    labels=("monitor",))
_M_TENANT_WEIGHT = obs_metrics.gauge(
    "tenant_weight_total", "sum of per-tenant anytime estimates",
    labels=("monitor",))

_M_TENANT_WINDOW_WEIGHT = obs_metrics.gauge(
    "tenant_window_weight", "sum of per-tenant windowed anytime estimates",
    labels=("monitor",))
_M_TENANT_WINDOW_EPOCH = obs_metrics.gauge(
    "tenant_window_epoch", "monotone epoch clock of the window ring",
    labels=("monitor",))

_M_VIRTUAL_POOL_LOAD = obs_metrics.gauge(
    "virtual_pool_load_factor", "fraction of shared-pool slots raised",
    labels=("monitor",))
_M_VIRTUAL_POOL_WEIGHT = obs_metrics.gauge(
    "virtual_pool_weight_total", "exact total live tail weight in the pool",
    labels=("monitor",))
_M_VIRTUAL_TAIL_ELEMENTS = obs_metrics.gauge(
    "virtual_tail_elements", "live tail element-occurrences folded",
    labels=("monitor",))

_TENANT_FAMILIES = {
    "tenant_elements_seen": _M_TENANT_SEEN,
    "tenant_slots_claimed": _M_TENANT_SLOTS,
    "tenant_collision_rate": _M_TENANT_COLLISIONS,
    "tenant_weight_total": _M_TENANT_WEIGHT,
    "tenant_window_weight": _M_TENANT_WINDOW_WEIGHT,
    "tenant_window_epoch": _M_TENANT_WINDOW_EPOCH,
    "virtual_pool_load_factor": _M_VIRTUAL_POOL_LOAD,
    "virtual_pool_weight_total": _M_VIRTUAL_POOL_WEIGHT,
    "virtual_tail_elements": _M_VIRTUAL_TAIL_ELEMENTS,
}


def directory_metrics(directory: DirectoryState) -> dict:
    """The two directory-health scalars every tenant surface reports."""
    return {
        "tenant_slots_claimed": (directory.fingerprints != 0).sum().to(torch.int32),
        "tenant_collision_rate": key_directory.collision_rate(directory),
    }


def publish_tenant_metrics(kind: str, values: dict) -> None:
    """Mirror a tenant ``metrics()`` dict into the registry (host floats;
    reads the device scalars)."""
    if not obs_metrics.enabled():
        return
    for name, v in values.items():
        fam = _TENANT_FAMILIES.get(name)
        if fam is not None:
            fam.labels(monitor=kind).set(float(v))


def tenant_metrics(kind: str, n_seen, directory: DirectoryState, **extras) -> dict:
    """The shared tenant ``metrics()`` body: stream counter + directory
    health + per-backend extras, in the JAX package's key order, published
    to the registry under ``monitor=kind``. Values stay tensors."""
    out = {"tenant_elements_seen": n_seen, **directory_metrics(directory)}
    out.update(extras)
    publish_tenant_metrics(kind, out)
    return out


class MonitorState(NamedTuple):
    """Scalar stream monitor: one full QSketch + an occurrence counter."""

    regs: torch.Tensor  # int8[m]
    n_seen: torch.Tensor  # int32 element counter (occurrences, not distinct)


def init(cfg: SketchConfig, device="cuda") -> MonitorState:
    """Fresh scalar monitor: empty QSketch, zero elements seen."""
    st = qsketch.init(cfg, device)
    return MonitorState(regs=st.regs, n_seen=torch.zeros((), dtype=torch.int32, device=st.regs.device))


def _flatten(ids, weights, mask):
    if isinstance(ids, tuple):  # sparse 64-bit element ids as a (lo, hi) pair
        lo, hi = ids
        ids = (lo.reshape(-1), hi.reshape(-1))
        ref = ids[0]
    else:
        ids = ids.reshape(-1)
        ref = ids
    n = ref.shape[0]
    w = (
        torch.ones((n,), dtype=torch.float32, device=ref.device)
        if weights is None
        else weights.reshape(-1).to(torch.float32)
    )
    mask = None if mask is None else mask.reshape(-1)
    n_live = n if mask is None else mask.to(torch.int32).sum()
    return ids, w, mask, n_live


def _flatten_keys(keys):
    """Flatten dense-slot or (lo, hi) sparse tenant keys uniformly."""
    if isinstance(keys, tuple):
        lo, hi = keys
        return lo.reshape(-1), hi.reshape(-1)
    return keys.reshape(-1)


def update(cfg: SketchConfig, state: MonitorState, ids, weights=None, mask=None) -> MonitorState:
    """Batched full-QSketch update (ids flattened; weight 1.0 if not given)."""
    ids, w, mask, n_live = _flatten(ids, weights, mask)
    st = qsketch.update(cfg, QSketchState(regs=state.regs), ids, w, mask=mask)
    return MonitorState(regs=st.regs, n_seen=state.n_seen + n_live)


def estimate(cfg: SketchConfig, state: MonitorState) -> torch.Tensor:
    """Weighted cardinality via the O(2^b) histogram MLE (full kind)."""
    hist = estimators.histogram(cfg, state.regs)
    return estimation.estimate_hist(cfg, hist, kind="full")


def merge(cfg: SketchConfig, a: MonitorState, b: MonitorState) -> MonitorState:
    """Exact union-stream merge (max monoid)."""
    return MonitorState(regs=torch.maximum(a.regs, b.regs), n_seen=a.n_seen + b.n_seen)


class ArrayMonitorState(NamedTuple):
    """Per-key monitor: K QSketch rows + a live-element counter."""

    regs: torch.Tensor  # int8[K, m]
    n_seen: torch.Tensor  # int32 live-element counter across all keys


def init_array(cfg: SketchConfig, k: int, device="cuda") -> ArrayMonitorState:
    """Fresh per-key monitor: K empty sketch rows, zero elements seen."""
    regs = sketch_array.init(cfg, k, device).regs
    return ArrayMonitorState(regs=regs, n_seen=torch.zeros((), dtype=torch.int32, device=regs.device))


def update_array(
    cfg: SketchConfig,
    state: ArrayMonitorState,
    keys,
    ids,
    weights=None,
    mask=None,
    dcfg: DirectoryConfig | None = None,
) -> ArrayMonitorState:
    """One fused keyed update: element i lands in sketch row keys[i] (the
    register matrix is updated in place; kernel K6 on the card).

    keys/ids/weights/mask share a leading shape and are flattened. With
    ``dcfg`` set, ``keys`` are sparse 64-bit tenant ids (an integer tensor
    or a (lo, hi) pair) routed statelessly through the key directory;
    without it they are dense slots in [0, K).
    """
    keys = _flatten_keys(keys)
    if dcfg is not None:
        keys = key_directory.route_slots(dcfg, keys)
    ids, w, mask, n_live = _flatten(ids, weights, mask)
    st = sketch_array.update(cfg, SketchArrayState(regs=state.regs), keys, ids, w, mask=mask)
    return ArrayMonitorState(regs=st.regs, n_seen=state.n_seen + n_live)


def estimate_array(cfg: SketchConfig, state: ArrayMonitorState) -> torch.Tensor:
    """All K weighted cardinalities: one batched histogram MLE, Ĉ[K]."""
    return sketch_array.estimate_all(cfg, SketchArrayState(regs=state.regs))


def merge_array(cfg: SketchConfig, a: ArrayMonitorState, b: ArrayMonitorState) -> ArrayMonitorState:
    """Row-wise exact union merge across shards/pods."""
    merged = sketch_array.merge(SketchArrayState(regs=a.regs), SketchArrayState(regs=b.regs))
    return ArrayMonitorState(regs=merged.regs, n_seen=a.n_seen + b.n_seen)


class DynArrayMonitorState(NamedTuple):
    """State of a DynArrayMonitor."""

    regs: torch.Tensor  # int8[K, m]
    hists: torch.Tensor  # int32[K, 2^b] batch-start q_R histograms
    chats: torch.Tensor  # f32[K] running per-tenant estimates
    directory: DirectoryState  # key-collision telemetry
    n_seen: torch.Tensor  # int32 live-element counter across all tenants


class DynArrayMonitor:
    """Per-tenant weighted-cardinality telemetry with O(1)-anytime reads.

    Sparse 64-bit tenant ids go through the key directory into a DynArray:
    every update advances a per-key §4.3 martingale, so ``estimate`` is a
    pure O(K) read of the running chats. ``update`` changes the state's
    tensors in place and returns them in a new tuple.

    Caveat (DESIGN.md §8.4): the chats are per-STREAM martingales; two
    monitors that may have seen the same element must ``merge`` (register
    max + per-key MLE re-estimate), never add their chats.

    The instance is configuration (and the device); all mutable data lives
    in ``DynArrayMonitorState``.
    """

    def __init__(self, cfg: SketchConfig, dcfg: DirectoryConfig, device="cuda"):
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)

    @classmethod
    def for_capacity(cls, cfg: SketchConfig, capacity: int, *, seed: int | None = None,
                     pinned: tuple = (), device="cuda"):
        """Build with a fresh directory config of ``capacity`` slots."""
        dcfg = DirectoryConfig(capacity=capacity, seed=cfg.seed if seed is None else seed, pinned=pinned)
        return cls(cfg, dcfg, device)

    def init(self) -> DynArrayMonitorState:
        """Fresh DynArray + empty directory telemetry on the monitor's device."""
        st = dyn_array.init(self.cfg, self.dcfg.capacity, self.device)
        return DynArrayMonitorState(
            regs=st.regs,
            hists=st.hists,
            chats=st.chats,
            directory=key_directory.init(self.dcfg, self.device),
            n_seen=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def update(self, state: DynArrayMonitorState, tenant_keys, ids, weights=None, mask=None) -> DynArrayMonitorState:
        """Fold a keyed batch: tenant_keys are sparse ids (an integer tensor
        or a (lo, hi) pair), flattened together with ids/weights/mask."""
        keys = _flatten_keys(tenant_keys)
        ids, w, mask, n_live = _flatten(ids, weights, mask)
        st, dir_state = dyn_array.update_tenants(
            self.cfg, self.dcfg,
            DynArrayState(regs=state.regs, hists=state.hists, chats=state.chats),
            state.directory, keys, ids, w, mask=mask,
        )
        return DynArrayMonitorState(
            regs=st.regs, hists=st.hists, chats=st.chats,
            directory=dir_state, n_seen=state.n_seen + n_live,
        )

    def estimate(self, state: DynArrayMonitorState) -> torch.Tensor:
        """Ĉ[K] — the anytime read; no Newton, no histogram walk."""
        return dyn_array.estimate_all(
            DynArrayState(regs=state.regs, hists=state.hists, chats=state.chats)
        )

    def merge(self, a: DynArrayMonitorState, b: DynArrayMonitorState) -> DynArrayMonitorState:
        """Cross-pod union: register max, per-key MLE re-estimated chats,
        directory telemetry merge."""
        st = dyn_array.merge(
            self.cfg,
            DynArrayState(regs=a.regs, hists=a.hists, chats=a.chats),
            DynArrayState(regs=b.regs, hists=b.hists, chats=b.chats),
        )
        return DynArrayMonitorState(
            regs=st.regs, hists=st.hists, chats=st.chats,
            directory=key_directory.merge(a.directory, b.directory),
            n_seen=a.n_seen + b.n_seen,
        )

    def metrics(self, state: DynArrayMonitorState) -> dict:
        """Per-step scalars: stream + directory health, plus the total
        tracked weight (an O(K) sum of the anytime estimates)."""
        return tenant_metrics(
            "dyn_array", state.n_seen, state.directory,
            tenant_weight_total=state.chats.sum(),
        )


class WindowMonitorState(NamedTuple):
    """State of a WindowMonitor."""

    window: WindowArrayState  # epoch ring + cached union (core/window_array)
    directory: DirectoryState  # key-collision telemetry + aging stamps
    n_seen: torch.Tensor  # int32 live-element counter across all tenants


class WindowMonitor:
    """Per-tenant SLIDING-WINDOW weighted-cardinality telemetry.

    The ``DynArrayMonitor`` surface backed by ``core/window_array.py``:
    estimates answer "weighted distinct traffic in the last w <= E epochs",
    not "since init". Two verbs beyond the shared surface:

    * ``rotate(state)`` closes the current epoch (the caller's clock),
      evicting the oldest epoch once the ring is full, and ages directory
      slots untouched for ``evict_after`` epochs (0 disables aging);
    * ``estimate(state, w=None)``: ``w=None`` is the O(K) anytime read of
      the full-ring window; an integer w is the windowed histogram-MLE read
      over the last w epochs (kernel K7 on the card for w < E).

    ``update`` and ``rotate`` change the state's tensors in place and return
    them in a new tuple. The instance is configuration (and the device).
    """

    def __init__(self, cfg: SketchConfig, dcfg: DirectoryConfig, n_epochs: int, *,
                 evict_after: int = 0, device="cuda"):
        if evict_after < 0:
            raise ValueError("evict_after must be >= 0 (0 disables aging)")
        self.cfg = cfg
        self.dcfg = dcfg
        self.n_epochs = int(n_epochs)
        self.evict_after = int(evict_after)
        self.device = resolve_device(device)

    @classmethod
    def for_capacity(cls, cfg: SketchConfig, capacity: int, n_epochs: int, *, seed: int | None = None,
                     pinned: tuple = (), evict_after: int = 0, device="cuda"):
        """Build with a fresh directory config of ``capacity`` slots."""
        dcfg = DirectoryConfig(capacity=capacity, seed=cfg.seed if seed is None else seed, pinned=pinned)
        return cls(cfg, dcfg, n_epochs, evict_after=evict_after, device=device)

    def init(self) -> WindowMonitorState:
        """Fresh epoch ring + empty directory telemetry on the monitor's device."""
        return WindowMonitorState(
            window=window_array.init(self.cfg, self.dcfg.capacity, self.n_epochs, self.device),
            directory=key_directory.init(self.dcfg, self.device),
            n_seen=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def update(self, state: WindowMonitorState, tenant_keys, ids, weights=None, mask=None) -> WindowMonitorState:
        """Fold a keyed batch into the CURRENT epoch: tenant_keys are sparse
        ids (an integer tensor or a (lo, hi) pair), flattened together with
        ids/weights/mask. Routed slots are stamped with the epoch clock."""
        keys = _flatten_keys(tenant_keys)
        ids, w, mask, n_live = _flatten(ids, weights, mask)
        win, dir_state = window_array.update_tenants(
            self.cfg, self.dcfg, state.window, state.directory, keys, ids, w, mask=mask,
        )
        return WindowMonitorState(window=win, directory=dir_state, n_seen=state.n_seen + n_live)

    def rotate(self, state: WindowMonitorState) -> WindowMonitorState:
        """Advance the epoch clock (evicting the oldest epoch once the ring
        is full); age cold directory slots if configured."""
        win = window_array.rotate(self.cfg, state.window)
        directory = state.directory
        if self.evict_after:
            directory, _ = key_directory.evict_older_than(
                self.dcfg, directory, win.epoch_id - self.evict_after
            )
        return WindowMonitorState(window=win, directory=directory, n_seen=state.n_seen)

    def estimate(self, state: WindowMonitorState, w: int | None = None) -> torch.Tensor:
        """Ĉ[K] over the trailing window: ``w=None`` the anytime O(K) read of
        the full ring, an int w in [1, E] the union MLE over the last w."""
        if w is None:
            return window_array.estimate_ring_anytime(state.window)
        return window_array.estimate_window(self.cfg, state.window, w)

    def merge(self, a: WindowMonitorState, b: WindowMonitorState) -> WindowMonitorState:
        """Cross-pod union of ring-aligned windows: per-epoch register max +
        MLE re-estimates, directory merge."""
        return WindowMonitorState(
            window=window_array.merge(self.cfg, a.window, b.window),
            directory=key_directory.merge(a.directory, b.directory),
            n_seen=a.n_seen + b.n_seen,
        )

    def metrics(self, state: WindowMonitorState) -> dict:
        """Per-step scalars: stream + directory health, the window clock and
        the total windowed weight (an O(K) sum of the anytime reads)."""
        return tenant_metrics(
            "window", state.n_seen, state.directory,
            tenant_window_weight=state.window.union_chats.sum(),
            tenant_window_epoch=state.window.epoch_id.clone(),  # the ring's is updated in place
        )


class VirtualDynMonitorState(NamedTuple):
    """State of a VirtualDynMonitor."""

    array: VirtualDynArrayState  # shared pool + pinned dense hot rows
    n_seen: torch.Tensor  # int32 live-element counter across all tenants


class VirtualDynMonitor:
    """Per-tenant telemetry where the long tail shares one register pool.

    The ``DynArrayMonitor`` surface backed by ``core/virtual_dyn_array.py``:
    the ``vcfg.pinned`` hot tenants keep dense Dyn rows (exact anytime
    martingales), every other tenant hashes its registers into one shared
    ``pool_size``-slot pool, so tail memory is O(pool) whatever the number
    of tenants. Tail reads are noise-cancelled estimates with a resolution
    floor of ``virtual_dyn_array.noise_floor``.

    Two deltas against the dense monitors, both forced by pooling:
    ``estimate(state, tenant_keys)`` takes the tenants to read (the tail is
    a hash range, not an enumerable axis), and no directory telemetry
    threads through (``metrics()`` reports pool pressure instead).
    ``promote`` returns a NEW (monitor, state) pair. ``update`` changes the
    state's tensors in place. The instance is configuration (and the
    device); all mutable data lives in ``VirtualDynMonitorState``.
    """

    def __init__(self, cfg: SketchConfig, vcfg: VirtualConfig, device="cuda"):
        self.cfg = cfg
        self.vcfg = vcfg
        self.device = resolve_device(device)

    @classmethod
    def for_pool(cls, cfg: SketchConfig, pool_size: int, *, pinned: tuple = (),
                 m_virtual: int | None = None, seed: int | None = None, device="cuda"):
        """Build with a fresh virtual config of ``pool_size`` slots."""
        vcfg = VirtualConfig(pool_size=pool_size, m_virtual=m_virtual, pinned=pinned,
                             seed=cfg.seed if seed is None else seed)
        return cls(cfg, vcfg, device)

    def init(self) -> VirtualDynMonitorState:
        """Fresh pool + empty hot rows, zero elements seen."""
        return VirtualDynMonitorState(
            array=virtual_dyn_array.init(self.cfg, self.vcfg, self.device),
            n_seen=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def update(self, state: VirtualDynMonitorState, tenant_keys, ids, weights=None, mask=None) -> VirtualDynMonitorState:
        """Fold a keyed batch: tenant_keys are sparse ids (an integer tensor
        or a (lo, hi) pair), flattened together with ids/weights/mask."""
        keys = _flatten_keys(tenant_keys)
        ids, w, mask, n_live = _flatten(ids, weights, mask)
        st = virtual_dyn_array.update_tenants(self.cfg, self.vcfg, state.array, keys, ids, w, mask=mask)
        return VirtualDynMonitorState(array=st, n_seen=state.n_seen + n_live)

    def estimate(self, state: VirtualDynMonitorState, tenant_keys) -> torch.Tensor:
        """Ŵ[T] for the QUERIED tenants: exact martingale reads for pinned
        tenants, noise-cancelled virtual reads for the tail."""
        return virtual_dyn_array.estimate_tenants(self.cfg, self.vcfg, state.array, _flatten_keys(tenant_keys))

    def merge(self, a: VirtualDynMonitorState, b: VirtualDynMonitorState) -> VirtualDynMonitorState:
        """Cross-pod union: pool max + hot-tier dense merge."""
        return VirtualDynMonitorState(
            array=virtual_dyn_array.merge(self.cfg, self.vcfg, a.array, b.array),
            n_seen=a.n_seen + b.n_seen,
        )

    def promote(self, state: VirtualDynMonitorState, tenant, *, migrate: bool = False) -> tuple["VirtualDynMonitor", VirtualDynMonitorState]:
        """Pin ``tenant`` into the hot tier: -> (monitor', state'); route new
        traffic through the returned pair (``virtual_dyn_array.promote``)."""
        vcfg, array = virtual_dyn_array.promote(self.cfg, self.vcfg, state.array, tenant, migrate=migrate)
        return (VirtualDynMonitor(self.cfg, vcfg, self.device),
                VirtualDynMonitorState(array=array, n_seen=state.n_seen))

    def metrics(self, state: VirtualDynMonitorState) -> dict:
        """Cheap per-step scalars (no solve): stream counter, pool pressure
        (load factor, exact pooled weight, tail occurrences) and the hot
        tier's total tracked weight, in the JAX package's key order."""
        out = {
            "tenant_elements_seen": state.n_seen,
            "virtual_pool_load_factor": virtual_dyn_array.pool_load_factor(state.array),
            "virtual_pool_weight_total": state.array.w_tail,
            "virtual_tail_elements": state.array.n_tail,
            "tenant_weight_total": state.array.hot.chats.sum(),
        }
        publish_tenant_metrics("virtual_dyn", out)
        return out
