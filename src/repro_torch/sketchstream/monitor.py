"""Stream telemetry monitors: the main-path surfaces of
``repro/sketchstream/monitor.py``.

* The scalar monitor (``MonitorState``, ``init`` / ``update`` /
  ``estimate`` / ``merge``): one FULL QSketch — every element updates all m
  registers (kernel K1 on the card) — plus an occurrence counter. Full
  QSketch rather than Dyn because its registers are a plain max monoid:
  merging monitors that saw the same elements is exact (DESIGN.md §4.3).
* ``DynArrayMonitor``: per-tenant weighted cardinality with O(1)-anytime
  reads — sparse 64-bit tenant ids through the key directory into a
  DynArray whose per-key martingales make ``estimate`` a pure O(K) read.

``tenant_metrics`` / ``directory_metrics`` publish the tenant surface's
scalars to the port's metrics registry (``obs/metrics.py``).

Padding: ``update`` takes an optional boolean ``mask`` (same leading shape
as ``ids``); masked-off rows neither touch the sketch nor count toward
``n_seen``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import dyn_array, estimation, estimators, key_directory, qsketch
from ..core.key_directory import DirectoryConfig, DirectoryState
from ..core.types import DynArrayState, QSketchState, SketchConfig, resolve_device
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

_TENANT_FAMILIES = {
    "tenant_elements_seen": _M_TENANT_SEEN,
    "tenant_slots_claimed": _M_TENANT_SLOTS,
    "tenant_collision_rate": _M_TENANT_COLLISIONS,
    "tenant_weight_total": _M_TENANT_WEIGHT,
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
