"""Sparse tenant-key directory: 64-bit tenant ids -> DynArray slots.

The port of ``repro/core/key_directory.py`` for the main path: routing
(stateless: slot(x) is a pure function of the tenant id and the frozen
``DirectoryConfig``, the same hash family as the JAX package, so both
packages route a tenant to the same slot), pinned hot tenants with
dedicated slots [0, len(pinned)), and the collision telemetry (a per-slot
32-bit claim fingerprint, routed and collided counters, last-touch
stamps), and the aging of cold slots (``evict_older_than``). ``pin`` is not
ported yet.

Telemetry approximations (the JAX package's documented contract):
first-contact claims within ONE batch resolve by max fingerprint and are not
counted as collisions until a later batch revisits the slot; a fingerprint
match is necessary but not sufficient for identity.

Representation: fingerprints are uint32 values held in int64 tensors.
``route`` updates the directory's slot arrays in place.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import hashing
from .types import resolve_device


@dataclasses.dataclass(frozen=True)
class DirectoryConfig:
    """Frozen routing config.

    Attributes:
      capacity: total slot count K (== the DynArray row count it fronts).
      seed: base salt; routing and fingerprint roles derive sub-salts.
      pinned: tuple of 64-bit tenant ids with dedicated slots
        [0, len(pinned)); everyone else hashes into [len(pinned), capacity).
    """

    capacity: int
    seed: int = 0x5EED
    pinned: tuple = ()

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError("directory capacity must be >= 1")
        if len(self.pinned) >= self.capacity:
            raise ValueError("pinned table must leave at least one hashed slot")
        if len(set(self.pinned)) != len(self.pinned):
            raise ValueError("pinned tenant ids must be distinct")
        for t in self.pinned:
            if not 0 <= int(t) < 2**64:
                raise ValueError(f"pinned tenant id out of 64-bit range: {t}")

    @property
    def num_pinned(self) -> int:
        """Dedicated hot-tenant slots [0, num_pinned)."""
        return len(self.pinned)

    @property
    def num_hashed(self) -> int:
        """Shared hashed slots [num_pinned, capacity)."""
        return self.capacity - self.num_pinned

    @property
    def salt_route(self) -> int:
        """Derived salt of the tenant -> slot routing hash role."""
        return (self.seed * 0x9E3779B1 + 11) & 0xFFFFFFFF

    @property
    def salt_fp(self) -> int:
        """Derived salt of the per-slot claim-fingerprint hash role."""
        return (self.seed * 0x9E3779B1 + 12) & 0xFFFFFFFF


class DirectoryState(NamedTuple):
    """Collision-telemetry state (routing itself is stateless).

    fingerprints: int64[capacity] holding uint32 values; 0 = never claimed,
      else the (nonzero) fingerprint of the first tenant seen on the slot.
    n_routed: int32 scalar — live elements routed so far.
    n_collisions: int32 scalar — routings whose slot fingerprint mismatched.
    last_touch: int32[capacity] — epoch of the last live owner routing
      (-1 = never).
    """

    fingerprints: torch.Tensor
    n_routed: torch.Tensor
    n_collisions: torch.Tensor
    last_touch: torch.Tensor


def init(dcfg: DirectoryConfig, device="cuda") -> DirectoryState:
    """Empty telemetry: no claims (fingerprint 0), zero counters, stamps -1."""
    dev = resolve_device(device)
    return DirectoryState(
        fingerprints=torch.zeros((dcfg.capacity,), dtype=torch.int64, device=dev),
        n_routed=torch.zeros((), dtype=torch.int32, device=dev),
        n_collisions=torch.zeros((), dtype=torch.int32, device=dev),
        last_touch=torch.full((dcfg.capacity,), -1, dtype=torch.int32, device=dev),
    )


def split_uint64(ids, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Host-side helper: numpy uint64/int tenant ids -> (lo, hi) int64 word
    tensors on ``device``."""
    ids = np.asarray(ids, dtype=np.uint64)
    lo = (ids & np.uint64(0xFFFFFFFF)).astype(np.int64)
    hi = (ids >> np.uint64(32)).astype(np.int64)
    dev = resolve_device(device)
    return torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)


def _fingerprint(dcfg: DirectoryConfig, lo, hi):
    """Nonzero uint32 tenant fingerprint (0 is the unclaimed sentinel)."""
    fp = hashing.hash_words((lo, hi), dcfg.salt_fp)
    return torch.where(fp == 0, torch.ones_like(fp), fp)


def _order_key(lo, hi):
    """int64 key that orders 64-bit ids (hi, lo) as unsigned values:
    (hi - 2^31)·2^32 + lo, which stays inside the int64 range."""
    return (hi - 2**31) * 2**32 + lo


@functools.lru_cache(maxsize=32)
def _pinned_table(pinned: tuple, device: torch.device):
    """(sorted order keys int64[P], pinned slot of each int64[P]) on ``device``."""
    keys, order = torch.sort(_order_key(*split_uint64([int(t) for t in pinned], device)), stable=True)
    return keys, order


def route_slots(dcfg: DirectoryConfig, keys) -> torch.Tensor:
    """Stateless tenant -> slot map, int64[B] in [0, capacity).

    ``keys`` is an integer tensor (see ``hashing.split_id64``) or a (lo, hi)
    pair. Pinned tenants override to their dedicated slot, found by one
    binary search in a sorted device table of the pinned ids (a fixed
    number of launches whatever the number of pinned tenants).
    """
    lo, hi = hashing.split_id64(keys)
    slots = dcfg.num_pinned + hashing.hash_mod((lo, hi), dcfg.salt_route, dcfg.num_hashed)
    if dcfg.num_pinned:
        table, pin_slot = _pinned_table(tuple(dcfg.pinned), lo.device)
        key = _order_key(lo, hi)
        at = torch.clamp(torch.searchsorted(table, key), max=dcfg.num_pinned - 1)
        slots = torch.where(table[at] == key, pin_slot[at], slots)
    return slots


def route(dcfg: DirectoryConfig, state: DirectoryState, keys, mask=None, epoch=None):
    """Route a batch AND update collision telemetry: -> (slots, state').

    The slot arrays of ``state`` are updated in place (and returned in
    ``state'`` with the new counters). Masked-off rows get a valid slot but
    touch neither the claim table nor the counters. ``epoch`` stamps each
    live owner slot's ``last_touch`` (default 0): an int, or an int32
    0-dim tensor on the directory's device (the window array's
    ``epoch_id``), which is read on the device without a host sync.
    """
    lo, hi = hashing.split_id64(keys)
    slots = route_slots(dcfg, (lo, hi))
    fp = _fingerprint(dcfg, lo, hi)
    live = torch.ones(lo.shape, dtype=torch.bool, device=lo.device) if mask is None else mask
    if isinstance(epoch, torch.Tensor):
        epoch = epoch.to(device=lo.device, dtype=torch.int32)
    else:
        epoch = 0 if epoch is None else int(epoch)

    cur = state.fingerprints[slots]
    collided = live & (cur != 0) & (cur != fp)
    # First-writer claim as a scatter-max: claimed slots contribute 0; a
    # contested fresh slot resolves to the max fingerprint, in any order.
    claim = torch.where(live & (cur == 0), fp, torch.zeros_like(fp))
    state.fingerprints.scatter_reduce_(0, slots, claim, "amax")
    # Only owner/claim traffic keeps a slot warm: a colliding routing must
    # not re-stamp the ghost fingerprint it collided with.
    touch = torch.where(live & ~collided, epoch, -1).to(torch.int32)
    state.last_touch.scatter_reduce_(0, slots, touch, "amax")
    return slots, DirectoryState(
        fingerprints=state.fingerprints,
        n_routed=state.n_routed + live.sum().to(torch.int32),
        n_collisions=state.n_collisions + collided.sum().to(torch.int32),
        last_touch=state.last_touch,
    )


def evict_older_than(dcfg: DirectoryConfig, state: DirectoryState, epoch):
    """Release hashed slots whose last live routing predates ``epoch``:
    -> (state', n_evicted int32 0-dim tensor).

    A released slot drops its fingerprint claim and its stamp resets to -1,
    so the next tenant routed there claims it first-contact instead of
    counting a collision against a ghost. Pinned slots [0, num_pinned) are
    exempt. The counters are untouched. The slot arrays are updated in
    place; ``epoch`` is an int or an int32 0-dim tensor.
    """
    slot_ids = torch.arange(dcfg.capacity, device=state.fingerprints.device)
    cold = (
        (slot_ids >= dcfg.num_pinned)
        & (state.fingerprints != 0)
        & (state.last_touch < epoch)
    )
    state.fingerprints.masked_fill_(cold, 0)
    state.last_touch.masked_fill_(cold, -1)
    return state, cold.sum().to(torch.int32)


def merge(a: DirectoryState, b: DirectoryState) -> DirectoryState:
    """Cross-host telemetry merge: claims resolve by max fingerprint; slots
    claimed by different tenants on the two hosts count one collision each."""
    if a.fingerprints.shape != b.fingerprints.shape:
        raise ValueError(
            "directory merge needs equal capacities, got "
            f"{tuple(a.fingerprints.shape)} vs {tuple(b.fingerprints.shape)}"
        )
    fa, fb = a.fingerprints, b.fingerprints
    cross = ((fa != 0) & (fb != 0) & (fa != fb)).sum().to(torch.int32)
    return DirectoryState(
        fingerprints=torch.maximum(fa, fb),
        n_routed=a.n_routed + b.n_routed,
        n_collisions=a.n_collisions + b.n_collisions + cross,
        last_touch=torch.maximum(a.last_touch, b.last_touch),
    )


def occupancy(state: DirectoryState) -> torch.Tensor:
    """Fraction of slots ever claimed (f32 scalar)."""
    claimed = (state.fingerprints != 0).to(torch.float32).sum()
    return claimed / state.fingerprints.shape[0]


def collision_rate(state: DirectoryState) -> torch.Tensor:
    """Collided routings / total routings (f32 scalar; 0 for an empty dir)."""
    n = torch.clamp(state.n_routed.to(torch.float32), min=1.0)
    return state.n_collisions.to(torch.float32) / n
