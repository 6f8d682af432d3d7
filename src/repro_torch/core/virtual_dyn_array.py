"""VirtualDynArray: register-sharing virtual sketches for the long tail.

The port of ``repro/core/virtual_dyn_array.py``. Dense keyed containers pay
``int8[m] + int32[2^b] + f32`` per tenant; this container shares ONE
physical register pool ``int8[M]`` across the whole tail (the virtual-sketch
construction of Wang et al., arXiv 1811.09126): tail tenant t's logical
register j lives at

    p(t, j) = hash(t_lo, t_hi, j; salt_pool) mod M,

so the tail's memory is the pool's, whatever the number of tenants. A pool
slot is max-shared by every tenant whose (t, j) lands on it, so a tail read
estimates the tenant's own stream plus a ~(m_v/M) sample of everyone
else's, and cancels that noise at query time (DESIGN.md §8.9):

    Ŵ_t = max(0, (ρ·Ŵ_v - α·W_pool) / (1 - α)),   α = m_v/M,

with Ŵ_v the compound-Poisson profile solve of the tenant's m_v gathered
registers (``estimation.estimate_rows_virtual``), W_pool the exact
``w_tail`` accumulator and ρ the in-vivo calibration (``pool_calibration``).

Pinned hot tenants opt out of sharing and keep dedicated dense DynArray
rows (exact registers, exact martingale reads), routed statelessly through
the key directory. ``promote`` moves a tail tenant into the hot tier.

The update: the per-element placement — register choice j, value y, pool
slot p — runs in kernel K8 on a CUDA tensor (its plain version on a CPU
tensor); the hot rows' q_R runs in kernel K3 and the rest of their update is
``dyn_array._apply_update``; the pool's slot-grouped scatter-max and the
incremental FULL-histogram moves (bin 0 counts untouched r_min slots; bins
always sum to M) are PyTorch ops. As in ``dyn_array``, the update writes the
state's tensors in place (pool, pool_hist and the hot rows) and returns the
state with new ``n_tail`` / ``w_tail`` scalars; clone a state to keep it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import dyn_array, estimation, estimators, hashing, key_directory, qsketch_dyn
from .types import DynArrayState, SketchConfig, VirtualDynArrayState, resolve_device


@dataclasses.dataclass(frozen=True)
class VirtualConfig:
    """Frozen (hashable) virtual-tier config.

    Attributes:
      pool_size: M, the shared physical register pool slots. Must exceed the
        virtual register count (noise cancellation divides by 1 - m_v/M); in
        practice M >> m_v: 2^26 slots = 64 MiB serves 1e7 tenants.
      m_virtual: m_v, registers per VIRTUAL (tail) row — None means cfg.m.
        Virtual registers are a hash range, not storage: wider rows cut
        estimation variance but raise the noise floor (α = m_v/M).
      pinned: tuple of 64-bit tenant ids in the hot tier, each with a
        dedicated dense DynArray row [0, len(pinned)) in this order.
      seed: base salt; the pool-placement role derives its own sub-salt.
    """

    pool_size: int
    m_virtual: int | None = None
    pinned: tuple = ()
    seed: int = 0x5EED

    def __post_init__(self):
        if self.pool_size < 3:
            raise ValueError("virtual pool needs pool_size >= 3 slots")
        if self.m_virtual is not None and self.m_virtual < 2:
            raise ValueError("m_virtual must be >= 2 virtual registers")
        if len(set(self.pinned)) != len(self.pinned):
            raise ValueError("pinned tenant ids must be distinct")
        for t in self.pinned:
            if not 0 <= int(t) < 2**64:
                raise ValueError(f"pinned tenant id out of 64-bit range: {t}")

    @property
    def num_hot(self) -> int:
        """Dedicated dense rows (== len(pinned))."""
        return len(self.pinned)

    @property
    def salt_pool(self) -> int:
        """Derived salt of the (tenant, register) -> pool-slot placement role."""
        return (self.seed * 0x9E3779B1 + 21) & 0xFFFFFFFF

    @property
    def directory(self) -> key_directory.DirectoryConfig:
        """The hot/tail routing directory: pinned tenants own slots
        [0, num_hot); every other tenant lands on the single sentinel slot
        num_hot, so tail membership is ``route_slots(...) >= num_hot``."""
        return key_directory.DirectoryConfig(capacity=self.num_hot + 1, seed=self.seed, pinned=self.pinned)


def tail_m(cfg: SketchConfig, vcfg: VirtualConfig) -> int:
    """m_v, the virtual (tail) row width: ``vcfg.m_virtual`` or cfg.m."""
    return cfg.m if vcfg.m_virtual is None else vcfg.m_virtual


def tail_config(cfg: SketchConfig, vcfg: VirtualConfig) -> SketchConfig:
    """Tail-geometry config: the dense register family (b, seed) at the
    virtual row width m_v; the hot tier keeps ``cfg``."""
    m_v = tail_m(cfg, vcfg)
    return cfg if m_v == cfg.m else SketchConfig(m=m_v, b=cfg.b, seed=cfg.seed)


def _check_pool(cfg: SketchConfig, vcfg: VirtualConfig) -> None:
    if vcfg.pool_size <= tail_m(cfg, vcfg):
        raise ValueError(
            f"pool_size {vcfg.pool_size} must exceed m_v {tail_m(cfg, vcfg)}: "
            "noise cancellation divides by 1 - m_v/M"
        )


def init(cfg: SketchConfig, vcfg: VirtualConfig, device="cuda") -> VirtualDynArrayState:
    """Fresh virtual tier on ``device``: empty pool (all r_min, the full
    histogram's mass in bin 0) and one dense DynArray row per pinned tenant
    (at least one placeholder row, which never receives traffic)."""
    _check_pool(cfg, vcfg)
    dev = resolve_device(device)
    pool_hist = torch.zeros((cfg.num_bins,), dtype=torch.int32, device=dev)
    pool_hist[0] = vcfg.pool_size
    return VirtualDynArrayState(
        pool=torch.full((vcfg.pool_size,), cfg.r_min, dtype=torch.int8, device=dev),
        pool_hist=pool_hist,
        n_tail=torch.zeros((), dtype=torch.int32, device=dev),
        w_tail=torch.zeros((), dtype=torch.float32, device=dev),
        hot=dyn_array.init(cfg, max(1, vcfg.num_hot), dev),
    )


def pool_slots(cfg: SketchConfig, vcfg: VirtualConfig, t_lo, t_hi, j) -> torch.Tensor:
    """Physical pool slot of (tenant, register j): int64 in [0, M).
    Broadcasts: ``t_lo[:, None]`` against ``j[None, :]`` gives a [T, m_v]
    gather map."""
    return hashing.hash_mod((t_lo, t_hi, j.to(torch.int64)), vcfg.salt_pool, vcfg.pool_size)


def virtual_rows(cfg: SketchConfig, vcfg: VirtualConfig, state, t_lo, t_hi) -> torch.Tensor:
    """The virtual register rows ``int8[T, m_v]`` of T tenants: each
    tenant's own stream max-merged with the other tail traffic that landed
    on the same slots."""
    j = torch.arange(tail_m(cfg, vcfg), dtype=torch.int64, device=t_lo.device)
    return state.pool[pool_slots(cfg, vcfg, t_lo[:, None], t_hi[:, None], j[None, :])]


def _apply_pool_update(cfg: SketchConfig, state: VirtualDynArrayState, p, y, w, live):
    """Fold live (p, y) pairs into the pool in place: slot-grouped
    scatter-max, one unit of FULL-histogram mass moved old-bin -> final-bin
    per raised slot (bin 0 included), and the tail counters. ``final`` is
    the group max of y_eff floored by the batch-start value — exactly what
    the scatter leaves there — as in ``dyn_array._apply_update``."""
    old = state.pool[p].to(torch.int32)
    changed = live & (y > old)
    y_eff = torch.where(changed, y, torch.full_like(y, cfg.r_min))

    order = torch.sort(p).indices
    sp = p[order]
    starts = torch.ones_like(live)
    starts[1:] = sp[1:] != sp[:-1]
    seg = torch.cumsum(starts, 0) - 1
    smax = torch.full_like(y_eff, cfg.r_min).scatter_reduce_(0, seg, y_eff[order], "amax")
    final_sorted = torch.maximum(old[order], smax[seg])
    final = torch.empty_like(final_sorted)
    final[order] = final_sorted
    slot_first = torch.empty_like(starts)
    slot_first[order] = starts
    slot_changed = (slot_first & (final > old)).to(torch.int32)

    # Every row of a slot group writes the same final value.
    state.pool[p] = final.to(torch.int8)
    state.pool_hist.index_add_(0, (old - cfg.r_min).to(torch.int64), -slot_changed)
    state.pool_hist.index_add_(0, (final - cfg.r_min).to(torch.int64), slot_changed)
    return state._replace(
        n_tail=state.n_tail + live.sum().to(torch.int32),
        w_tail=state.w_tail + torch.where(live, w, torch.zeros_like(w)).sum(),
    )


def _apply_update(cfg: SketchConfig, vcfg: VirtualConfig, state: VirtualDynArrayState,
                  t_lo, t_hi, lo, hi, w, live, p, y) -> VirtualDynArrayState:
    """Hot/tail split on the placement (p, y): hot traffic runs the exact
    dense DynArray update on the pinned rows (q_R in kernel K3), tail
    traffic scatter-maxes into the shared pool."""
    from ..kernels import ops  # deferred: kernels import core

    slots = key_directory.route_slots(vcfg.directory, (t_lo, t_hi))
    is_hot = slots < vcfg.num_hot
    hot_keys = torch.clamp(slots, 0, state.hot.regs.shape[0] - 1).contiguous()
    q = ops.dyn_array_update_op(cfg, state.hot.hists, hot_keys, w)
    hot = dyn_array._apply_update(cfg, state.hot, hot_keys, lo, hi, w, live & is_hot, q)
    return _apply_pool_update(cfg, state._replace(hot=hot), p, y, w, live & ~is_hot)


def update_tenants(cfg: SketchConfig, vcfg: VirtualConfig, state: VirtualDynArrayState,
                   tenant_keys, ids, weights, mask=None) -> VirtualDynArrayState:
    """One batch over sparse 64-bit tenant ids, in place (see the module
    docstring); returns the state.

    Pinned tenants update their dense rows with the full DynArray semantics
    (per-(tenant, id) dedup, incremental histograms, the batch-stale
    martingale). Tail tenants scatter-max into the pool; a duplicate maps to
    the same (slot, value), so no dedup is needed. The tail's register
    choice and value run under the virtual row width m_v (kernel K8); the
    hot rows recompute theirs under ``cfg``. ``mask``: optional bool[B];
    masked rows and degenerate weights are dropped.
    """
    from ..kernels import ops  # deferred: kernels import core

    t_lo, t_hi = hashing.split_id64(tenant_keys)
    lo, hi = hashing.split_id64(ids)
    w = weights.to(torch.float32).contiguous()
    live = qsketch_dyn._live_weight_mask(w, mask)
    t_lo, t_hi, lo, hi = (x.contiguous() for x in (t_lo, t_hi, lo, hi))
    p, y = ops.virtual_pool_route_op(
        cfg, tail_m(cfg, vcfg), vcfg.salt_pool, vcfg.pool_size, lo, hi, t_lo, t_hi, torch.log2(w)
    )
    return _apply_update(cfg, vcfg, state, t_lo, t_hi, lo, hi, w, live, p, y)


def estimate_pool_total(cfg: SketchConfig, vcfg: VirtualConfig, state: VirtualDynArrayState,
                        *, solver: str = "newton") -> torch.Tensor:
    """Ŵ_pool: total tail weight folded into the pool, from the maintained
    full pool histogram — an O(2^b) read (``estimation.estimate_pool_hist``)."""
    return estimation.estimate_pool_hist(cfg, state.pool_hist, vcfg.pool_size, solver=solver)


def estimate_tenants(cfg: SketchConfig, vcfg: VirtualConfig, state: VirtualDynArrayState,
                     tenant_keys, *, solver: str = "newton") -> torch.Tensor:
    """Ŵ per queried tenant, float32[T] — the noise-cancelled virtual read.

    Pinned tenants return their dense row's running martingale ONLY (the
    pool never contributes, which makes ``promote`` residue-safe). Tail
    tenants gather their m_v pool registers, solve the compound-Poisson
    profile MLE, scale by ρ and cancel the expected cross-tenant noise.
    Unknown tenants read about 0. Query in chunks: the gather map of T
    tenants is an int64[T, m_v] tensor.
    """
    _check_pool(cfg, vcfg)
    t_lo, t_hi = hashing.split_id64(tenant_keys)
    slots = key_directory.route_slots(vcfg.directory, (t_lo, t_hi))
    is_hot = slots < vcfg.num_hot

    tcfg = tail_config(cfg, vcfg)
    chat_v = estimation.estimate_rows_virtual(tcfg, virtual_rows(cfg, vcfg, state, t_lo, t_hi), solver=solver)
    rho = pool_calibration(cfg, vcfg, state, solver=solver)
    cancelled = estimation.cancel_pool_noise(tcfg, rho * chat_v, state.w_tail, vcfg.pool_size)
    hot_chats = state.hot.chats[torch.clamp(slots, 0, state.hot.regs.shape[0] - 1)]
    return torch.where(is_hot, hot_chats, cancelled)


def pool_calibration(cfg: SketchConfig, vcfg: VirtualConfig, state: VirtualDynArrayState,
                     *, solver: str = "newton") -> torch.Tensor:
    """ρ = w_tail / Ŵ_pool, clamped to [0.5, 2] (1.0 on an empty pool): the
    ratio of the pool's exact total to its own profile solve, which
    calibrates the row solves at the live workload's weight dispersion."""
    chat_pool = estimate_pool_total(cfg, vcfg, state, solver=solver)
    rho = torch.where(chat_pool > 0.0, state.w_tail / chat_pool, torch.ones_like(chat_pool))
    return torch.clamp(rho, 0.5, 2.0)


def pool_load_factor(state: VirtualDynArrayState) -> torch.Tensor:
    """Fraction of pool slots ever raised above r_min (float32 scalar): the
    saturation signal (the cancellation degrades past about 0.5)."""
    return 1.0 - state.pool_hist[0].to(torch.float32) / state.pool.shape[0]


def noise_floor(cfg: SketchConfig, vcfg: VirtualConfig, state: VirtualDynArrayState) -> torch.Tensor:
    """Expected cross-tenant noise weight on ONE tenant's virtual row,
    α·W_pool / (1 - α) (float32 scalar) — what the cancellation subtracts."""
    _check_pool(cfg, vcfg)
    alpha = tail_m(cfg, vcfg) / vcfg.pool_size
    return torch.tensor(np.float32(alpha / (1.0 - alpha)), device=state.w_tail.device) * state.w_tail


def rebuild_pool_hist(cfg: SketchConfig, pool) -> torch.Tensor:
    """Full pool histogram from scratch (bins sum to M): the O(M) reference
    of the incremental maintenance, and what ``merge`` uses."""
    return torch.bincount(pool.to(torch.int64) - cfg.r_min, minlength=cfg.num_bins).to(torch.int32)


def merge(cfg: SketchConfig, vcfg: VirtualConfig, a: VirtualDynArrayState,
          b: VirtualDynArrayState) -> VirtualDynArrayState:
    """Merge two fleets' states: pool element-wise max (exact union) with a
    rebuilt histogram; hot tier ``dyn_array.merge``; ``n_tail`` and
    ``w_tail`` add (exact for disjoint shards; overlapping streams inflate
    ``w_tail`` and the tail reads go conservative). Returns a new state."""
    if a.pool.shape != b.pool.shape:
        raise ValueError(
            f"virtual merge needs matching pools, got {tuple(a.pool.shape)} vs {tuple(b.pool.shape)}"
        )
    pool = torch.maximum(a.pool, b.pool)
    return VirtualDynArrayState(
        pool=pool,
        pool_hist=rebuild_pool_hist(cfg, pool),
        n_tail=a.n_tail + b.n_tail,
        w_tail=a.w_tail + b.w_tail,
        hot=dyn_array.merge(cfg, a.hot, b.hot),
    )


def promote(cfg: SketchConfig, vcfg: VirtualConfig, state: VirtualDynArrayState, tenant,
            *, migrate: bool = False) -> tuple[VirtualConfig, VirtualDynArrayState]:
    """Pin a tail tenant into the hot tier: -> (vcfg', state').

    ``vcfg'`` appends ``tenant`` to ``pinned``; ``state'`` has one more dense
    row (the unpinned placeholder row is dropped). Later traffic of the
    tenant updates that row and its estimates read it only, so promotion
    never double-counts; pool placement never sees the pinned set, so no
    other tenant moves. The pool is untouched.

    migrate=False (default), the epoch fence: the new row starts empty.
    migrate=True: the row seeds from the tenant's gathered pool registers,
    with a rebuilt histogram and a chat from the routed histogram MLE (the
    ``merge`` convention); needs m_virtual == cfg.m.
    """
    t = int(tenant)
    if t in tuple(int(x) for x in vcfg.pinned):
        raise ValueError(f"tenant {tenant} is already pinned")
    if migrate and tail_m(cfg, vcfg) != cfg.m:
        raise ValueError(
            "promote(migrate=True) needs m_virtual == cfg.m: a virtual row "
            "under a different register modulus cannot seed a dense row "
            "— use migrate=False (epoch fence) instead"
        )
    vcfg2 = dataclasses.replace(vcfg, pinned=vcfg.pinned + (t,))
    dev = state.pool.device

    if migrate:
        t_lo, t_hi = key_directory.split_uint64([t], dev)
        row_regs = virtual_rows(cfg, vcfg, state, t_lo, t_hi)[0]
        row_hist = estimators.histogram(cfg, row_regs)
        row_hist[0] = 0
        full = row_hist.clone()
        full[0] = cfg.m - row_hist.sum()
        row_chat = estimation.estimate_hist(cfg, full, kind="routed")
    else:
        row_regs = torch.full((cfg.m,), cfg.r_min, dtype=torch.int8, device=dev)
        row_hist = torch.zeros((cfg.num_bins,), dtype=torch.int32, device=dev)
        row_chat = torch.zeros((), dtype=torch.float32, device=dev)

    num_hot, hot = vcfg.num_hot, state.hot
    hot2 = DynArrayState(
        regs=torch.cat([hot.regs[:num_hot], row_regs[None, :]]),
        hists=torch.cat([hot.hists[:num_hot], row_hist[None, :]]),
        chats=torch.cat([hot.chats[:num_hot], row_chat.reshape(1)]),
    )
    return vcfg2, state._replace(hot=hot2)


def memory_bytes(cfg: SketchConfig, vcfg: VirtualConfig) -> int:
    """Device bytes of one VirtualDynArrayState: pool + pool histogram +
    counters + the pinned hot rows — independent of the tail tenant count."""
    pool = vcfg.pool_size + 4 * cfg.num_bins + 4 + 4
    return pool + max(1, vcfg.num_hot) * (cfg.m + 4 * cfg.num_bins + 4)


def dense_memory_bytes(cfg: SketchConfig, k: int) -> int:
    """Device bytes of a dense ``DynArrayState`` with k tenant rows."""
    return k * (cfg.m + 4 * cfg.num_bins + 4)


def update_reference(cfg: SketchConfig, vcfg: VirtualConfig, state: VirtualDynArrayState,
                     tenant_keys, ids, weights, mask=None) -> VirtualDynArrayState:
    """Oracle: sequential application of the hot/tail semantics. The hot
    sub-stream runs through ``dyn_array.update_reference``; the pool applies
    each live element's (p, y) one at a time with full-histogram mass moves.
    Tests only — O(B) Python. Returns a new state; ``state`` is unchanged."""
    t_lo, t_hi = hashing.split_id64(tenant_keys)
    lo, hi = hashing.split_id64(ids)
    w = weights.to(torch.float32)
    live = qsketch_dyn._live_weight_mask(w, mask)
    slots = key_directory.route_slots(vcfg.directory, (t_lo, t_hi))
    is_hot = slots < vcfg.num_hot

    j, y = qsketch_dyn._choose_and_quantize(tail_config(cfg, vcfg), lo, hi, w)
    p = pool_slots(cfg, vcfg, t_lo, t_hi, j).cpu().numpy()
    y_np = y.cpu().numpy()

    hot = dyn_array.update_reference(
        cfg, state.hot, torch.clamp(slots, 0, state.hot.regs.shape[0] - 1), (lo, hi), w,
        mask=live & is_hot,
    )
    pool = state.pool.cpu().numpy().copy()
    hist = state.pool_hist.cpu().numpy().copy()
    tail = (live & ~is_hot).cpu().numpy()
    # The update's batch-sum expression, so the float32 scalar is the same.
    w_tail = state.w_tail + torch.where(live & ~is_hot, w, torch.zeros_like(w)).sum()
    for i in np.flatnonzero(tail):
        old = int(pool[p[i]])
        if y_np[i] > old:
            hist[old - cfg.r_min] -= 1
            hist[y_np[i] - cfg.r_min] += 1
            pool[p[i]] = y_np[i]
    dev = state.pool.device
    return VirtualDynArrayState(
        pool=torch.from_numpy(pool).to(dev),
        pool_hist=torch.from_numpy(hist).to(dev),
        n_tail=state.n_tail + int(tail.sum()),
        w_tail=w_tail,
        hot=hot,
    )
