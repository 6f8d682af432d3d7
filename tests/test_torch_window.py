"""The port's sliding-window path (WindowArray, WindowMonitor, AnomalyBank;
kernel K7's path) against the JAX package on the CPU.

Same inputs, made from a seed with numpy, through both packages. Integer
state (registers, histograms, union, ring scalars, directory) bit for bit;
running estimates (chats) to rtol 1e-5, atol 1e-6 (``tests/test_dyn_array.py``'s
tolerance: float32 sums in another order); MLE reads to rtol 1e-5 against
the JAX newton solve with ``ATOL_FLOOR`` absolute, on rows where every
register is touched (the routed MLE collapses to ~0 on sparse rows, in the
reference too, DESIGN.md §10.4); anomaly scores to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SketchConfig as JCfg
from repro.core import estimators as jest
from repro.core import key_directory as jkd
from repro.core import window_array as jwa
from repro.kernels import ops as jops
from repro.kernels import window_union as jk7
from repro.obs import metrics as jmetrics
from repro.sketchstream import anomaly as janom
from repro.sketchstream import monitor as jmon
from repro_torch import convert
from repro_torch.core import SketchConfig, estimation, estimators, key_directory, window_array
from repro_torch.core.types import WindowArrayState
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref
from repro_torch.obs import metrics as port_metrics
from repro_torch.sketchstream import anomaly, monitor

CHAT_TOL = dict(rtol=1e-5, atol=1e-6)
MLE_TOL = dict(rtol=1e-5, atol=estimation.ATOL_FLOOR)
# (batch, m, K, E) — ragged on purpose, as in tests/test_window_array.py.
SHAPES = [(256, 64, 8, 4), (100, 130, 7, 3)]
INT_FIELDS = ("regs", "hists", "union_regs", "union_hists", "head", "filled", "epoch_id")


@pytest.fixture
def jax_registry_off():
    """The JAX ops fronts and monitors reach ``jax.core.trace_state_clean``
    (gone in this jax) only while the JAX registry is on: switch it off for
    the test and restore the process-wide state afterwards."""
    was = jmetrics.enabled()
    jmetrics.configure(enabled=False)
    yield
    jmetrics.configure(enabled=was)


@pytest.fixture
def port_registry_on():
    """Switch the port's registry on and restore its earlier state."""
    was = port_metrics.enabled()
    port_metrics.configure(enabled=True)
    yield
    port_metrics.configure(enabled=was)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _ids_t(ids):
    return torch.from_numpy(np.asarray(ids).astype(np.int64))


def _keyed(batch, k, seed, *, n_ids=None, dense_keys=0):
    """Keyed batch with duplicates, zero weights and a mask. With
    ``dense_keys`` > 0 every row goes to keys [0, dense_keys) with fresh
    ids, so those rows fill up."""
    rng = np.random.default_rng(seed)
    if dense_keys:
        keys = rng.integers(0, dense_keys, batch).astype(np.int32)
        ids = rng.integers(0, 2**32, batch, dtype=np.uint32)
        w = (rng.gamma(1.0, 2.0, batch) + 1e-4).astype(np.float32)
        return keys, ids, w, np.ones(batch, bool)
    pool = rng.integers(0, 2**32, n_ids or batch, dtype=np.uint32)
    ids = pool[rng.integers(0, len(pool), batch)]
    w = (rng.gamma(1.0, 2.0, batch) + 1e-4).astype(np.float32)
    w[rng.random(batch) < 0.05] = 0.0
    mask = rng.random(batch) > 0.1
    keys = rng.integers(0, k, batch).astype(np.int32)
    return keys, ids, w, mask


def _assert_window(port, jax_state):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(jax_state, name)), err_msg=name)
    np.testing.assert_allclose(port.chats.numpy(), np.asarray(jax_state.chats), **CHAT_TOL)
    np.testing.assert_allclose(port.union_chats.numpy(), np.asarray(jax_state.union_chats), **CHAT_TOL)


def _drive_both(cfg_j, cfg, k, e, n_epochs, *, batch=256, batches_per_epoch=2, seed=0, dense_keys=0, check=True):
    """Run both packages over n_epochs epochs (rotating between them)."""
    sj, st = jwa.init(cfg_j, k, e), window_array.init(cfg, k, e, device="cpu")
    for ep in range(n_epochs):
        for i in range(batches_per_epoch):
            keys, ids, w, mask = _keyed(batch, k, seed + 31 * ep + i, n_ids=batch // 2, dense_keys=dense_keys)
            sj = jwa.update_batch(cfg_j, sj, jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
            out = window_array.update_batch(cfg, st, _t(keys), _ids_t(ids), _t(w), mask=_t(mask))
            assert out is st
            if check:
                _assert_window(st, sj)
        if ep < n_epochs - 1:
            sj = jwa.rotate(cfg_j, sj)
            window_array.rotate(cfg, st)
            if check:
                _assert_window(st, sj)
    return sj, st


@pytest.mark.parametrize("batch,m,k,e", SHAPES)
def test_update_and_rotate_match_jax_across_the_wrap(batch, m, k, e):
    """E + 2 rotations: the ring wraps and evicts; every step equal."""
    cfg_j, cfg = JCfg(m=m, b=8, seed=m + k), SketchConfig(m=m, b=8, seed=m + k)
    sj, st = _drive_both(cfg_j, cfg, k, e, n_epochs=e + 3, batch=batch, seed=k)
    assert int(st.head) == (e + 2) % e and int(st.filled) == e and int(st.epoch_id) == e + 2
    np.testing.assert_array_equal(st.union_regs.numpy(), st.regs.numpy().max(axis=0))
    assert (st.union_chats.numpy() >= 0).all()


def test_update_lands_in_the_ring_in_place():
    cfg = SketchConfig(m=64, b=8, seed=3)
    k, e = 6, 3
    st = window_array.init(cfg, k, e, device="cpu")
    window_array.rotate(cfg, st)  # head = 1: the update must land in plane 1
    ring_before = st.regs.clone()
    keys, ids, w, _ = _keyed(300, k, seed=1, dense_keys=k)
    out = window_array.update_batch(cfg, st, _t(keys), _ids_t(ids), _t(w))
    assert out is st and out.regs is st.regs
    changed = (st.regs != ring_before).any(dim=(1, 2))
    assert changed.tolist() == [False, True, False]
    assert (st.hists[1].sum(1) > 0).all() and (st.chats[1] > 0).all()
    assert st.hists[0].sum() == 0 and st.hists[2].sum() == 0
    np.testing.assert_array_equal(st.union_regs.numpy(), st.regs[1].numpy())
    window_array.rotate(cfg, st)
    window_array.rotate(cfg, st)
    window_array.rotate(cfg, st)  # head back at 1: that epoch is evicted
    assert int(st.head) == 1
    assert (st.regs == cfg.r_min).all() and st.union_chats.abs().sum() == 0


def _dense_ring(e, k, m, seed):
    """Both packages after e + 1 epochs of dense traffic on keys 0-2 (~1000
    fresh elements per row per epoch at m = 64: every register touched)."""
    cfg_j, cfg = JCfg(m=m, b=8, seed=seed), SketchConfig(m=m, b=8, seed=seed)
    sj, st = _drive_both(cfg_j, cfg, k, e, n_epochs=e + 1, batch=1500, batches_per_epoch=2,
                         seed=seed, dense_keys=3, check=False)
    _assert_window(st, sj)
    return cfg_j, cfg, sj, st


def test_estimate_window_every_w_on_dense_rows_matches_jax(jax_registry_off):
    e, k, m = 4, 5, 64
    cfg_j, cfg, sj, st = _dense_ring(e, k, m, seed=21)
    for w in range(1, e + 1):
        got = window_array.estimate_window(cfg, st, w).numpy()
        want = np.asarray(jwa.estimate_window(cfg_j, sj, w))
        assert (want[:3] > 1000).all() and (got[:3] > 1000).all(), w
        np.testing.assert_allclose(got, want, **MLE_TOL)
        if w < e:
            np.testing.assert_allclose(
                got, np.asarray(jops.window_union_estimate_op(cfg_j, sj, w, interpret=True)), **MLE_TOL
            )
            # The union histograms the MLE reads: bit for bit.
            np.testing.assert_array_equal(
                ops.window_union_op(cfg, st.regs, st.head, w).numpy(),
                np.stack([np.asarray(jest.histogram(cfg_j, r)) for r in jwa.window_union_regs(sj, w)]),
            )
        np.testing.assert_array_equal(
            window_array.window_union_regs(st, w).numpy(), np.asarray(jwa.window_union_regs(sj, w))
        )
    # Rows 0-2 are dense, so every window's MLE grows with w.
    reads = np.stack([window_array.estimate_window(cfg, st, w).numpy()[:3] for w in range(1, e + 1)])
    assert (np.diff(reads, axis=0) > 0).all()
    with pytest.raises(ValueError, match="out of range"):
        window_array.estimate_window(cfg, st, e + 1)
    for r in range(3):
        oracle = jest.mle_numpy(cfg_j, np.asarray(jwa.window_union_regs(sj, 2))[r]) * cfg.m
        got = float(window_array.estimate_window(cfg, st, 2)[r])
        assert abs(got - oracle) <= estimation.LUT_RTOL * oracle + estimation.ATOL_FLOOR


@pytest.mark.parametrize("e,k,m,b", [(4, 8, 64, 8), (5, 3, 130, 4), (3, 17, 96, 8)])
def test_k7_plain_matches_jax_padded_kernel_at_several_heads(e, k, m, b):
    cfg = SketchConfig(m=m, b=b)
    rng = np.random.default_rng(e * 100 + k)
    regs = rng.integers(cfg.r_min, cfg.r_max + 1, (e, k, m)).astype(np.int8)
    regs[:, :, ::3] = cfg.r_min  # untouched registers land in bin 0
    bk, kp, mp, nbp = 8, -(-k // 8) * 8, -(-m // 128) * 128, -(-cfg.num_bins // 128) * 128
    regs_p = np.full((e, kp, mp), cfg.r_min, np.int8)
    regs_p[:, :k, :m] = regs
    for head in (0, 2, e - 1):
        for w in range(1, e + 1):
            age = (head - np.arange(e)) % e
            include = (age < w).astype(np.int32)[:, None]
            _, hist_j = jk7.window_union_padded(
                jnp.asarray(regs_p), jnp.asarray(include), m=m, nb_padded=nbp, r_min=cfg.r_min,
                block_k=bk, interpret=True,
            )
            got = ref.window_union_ref(_t(regs), torch.tensor(head, dtype=torch.int32), w,
                                       r_min=cfg.r_min, nb=cfg.num_bins)
            np.testing.assert_array_equal(got.numpy(), np.asarray(hist_j)[:k, : cfg.num_bins])
            assert (got.sum(1) == m).all()
            front = ops.window_union_op(cfg, _t(regs), torch.tensor(head, dtype=torch.int32), w)
            np.testing.assert_array_equal(front.numpy(), got.numpy())


def test_k7_front_checks_operands():
    cfg = SketchConfig(m=64, b=8)
    st = window_array.init(cfg, 4, 3, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        ops.window_union_op(cfg, st.regs, st.head, 0)
    with pytest.raises(TypeError, match="dtype"):
        ops.window_union_op(cfg, st.regs, st.head.to(torch.int64), 1)
    with pytest.raises(ValueError, match="shape"):
        ops.window_union_op(cfg, st.regs, st.head.view(1), 1)
    with pytest.raises(ValueError, match="shape"):
        ops.window_union_op(cfg, st.regs[:, :, :32].contiguous(), st.head, 1)


def test_anytime_epochs_all_and_aligned_merge_match_jax():
    e, k, m = 3, 5, 64
    cfg_j, cfg, sj, st = _dense_ring(e, k, m, seed=31)
    np.testing.assert_allclose(
        window_array.estimate_ring_anytime(st).numpy(), np.asarray(jwa.estimate_ring_anytime(sj)), **CHAT_TOL
    )
    np.testing.assert_allclose(
        window_array.estimate_epochs_all(cfg, st).numpy(), np.asarray(jwa.estimate_epochs_all(cfg_j, sj)), **MLE_TOL
    )
    assert window_array.num_epochs(st) == e and window_array.num_sketches(st) == k
    # A second ring on the same clock, then the pod merge.
    sj2, st2 = _drive_both(cfg_j, cfg, k, e, n_epochs=e + 1, batch=400, seed=77, check=False)
    mj, mt = jwa.merge(cfg_j, sj, sj2), window_array.merge(cfg, st, st2)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(mt, name).numpy(), np.asarray(getattr(mj, name)), err_msg=name)
    np.testing.assert_allclose(mt.chats.numpy(), np.asarray(mj.chats), **MLE_TOL)
    np.testing.assert_allclose(mt.union_chats.numpy(), np.asarray(mj.union_chats), **MLE_TOL)
    assert (mt.union_chats.numpy()[:3] > 1000).all()
    # Merging a ring with itself re-estimates instead of doubling.
    np.testing.assert_allclose(
        window_array.merge(cfg, st, st).union_chats.numpy(),
        window_array.estimate_window(cfg, st, e).numpy(), rtol=0, atol=0,
    )
    with pytest.raises(ValueError, match="matching"):
        window_array.merge(cfg, st, window_array.init(cfg, k + 1, e, device="cpu"))
    with pytest.raises(ValueError, match="ring-aligned"):
        window_array.merge(cfg, st, window_array.rotate(cfg, st2))


def test_update_reference_matches_jax_and_the_fused_update():
    e, k, m = 3, 6, 64
    cfg_j, cfg = JCfg(m=m, b=8, seed=41), SketchConfig(m=m, b=8, seed=41)
    sj, st = _drive_both(cfg_j, cfg, k, e, n_epochs=2, batch=200, seed=5, check=False)
    keys, ids, w, mask = _keyed(200, k, seed=99, n_ids=120)
    args_j = (jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w))
    oj = jwa.update_reference(cfg_j, sj, *args_j, mask=jnp.asarray(mask))
    before = st.regs.clone()
    ot = window_array.update_reference(cfg, st, _t(keys), _ids_t(ids), _t(w), mask=_t(mask))
    assert torch.equal(st.regs, before)  # the oracle copies
    _assert_window(ot, oj)
    fused = window_array.update_batch(cfg, st, _t(keys), _ids_t(ids), _t(w), mask=_t(mask))
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(fused, name).numpy(), getattr(ot, name).numpy(), err_msg=name)
    np.testing.assert_allclose(fused.union_chats.numpy(), ot.union_chats.numpy(), **CHAT_TOL)


def _tenants(n, seed, n_pool=30):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64, n_pool, dtype=np.uint64)
    return pool[rng.integers(0, len(pool), n)], pool


def test_update_tenants_stamps_epochs_and_evict_older_than_matches_jax():
    k, e = 16, 3
    cfg_j, cfg = JCfg(m=64, b=8, seed=16), SketchConfig(m=64, b=8, seed=16)
    _, pool = _tenants(1, seed=0)
    pinned = (int(pool[2]),)
    dcfg_j = jkd.DirectoryConfig(capacity=k, seed=17, pinned=pinned)
    dcfg = key_directory.DirectoryConfig(capacity=k, seed=17, pinned=pinned)
    sj, dj = jwa.init(cfg_j, k, e), jkd.init(dcfg_j)
    st, dt = window_array.init(cfg, k, e, device="cpu"), key_directory.init(dcfg, "cpu")
    for ep in range(5):
        # Later epochs draw from a shrinking slice of the pool: cold slots.
        tenants = pool[np.random.default_rng(ep).integers(0, max(4, 30 - 7 * ep), 150)]
        _, ids, w, mask = _keyed(150, k, seed=60 + ep, n_ids=100)
        kj, kt = jkd.split_uint64(tenants), key_directory.split_uint64(tenants, device="cpu")
        sj, dj = jwa.update_tenants(cfg_j, dcfg_j, sj, dj, kj, jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
        st, dt = window_array.update_tenants(cfg, dcfg, st, dt, kt, _ids_t(ids), _t(w), mask=_t(mask))
        _assert_window(st, sj)
        for name in jkd.DirectoryState._fields:
            np.testing.assert_array_equal(getattr(convert.to_numpy(dt), name), np.asarray(getattr(dj, name)))
        sj, st = jwa.rotate(cfg_j, sj), window_array.rotate(cfg, st)
    assert int(dt.last_touch.max()) == 4
    evicted = []
    for horizon in (2, 4, 4):  # an int, then a tensor clock; the repeat finds nothing
        clock = horizon if len(evicted) == 0 else torch.tensor(horizon, dtype=torch.int32)
        ej, nj = jkd.evict_older_than(dcfg_j, dj, jnp.int32(horizon))
        et, nt = key_directory.evict_older_than(dcfg, dt, clock)
        assert et.fingerprints is dt.fingerprints  # in place
        assert int(nt) == int(nj)
        evicted.append(int(nt))
        for name in jkd.DirectoryState._fields:
            np.testing.assert_array_equal(getattr(convert.to_numpy(et), name), np.asarray(getattr(ej, name)))
        dj = ej
    assert evicted[0] > 0 and evicted[1] > 0 and evicted[2] == 0
    assert int(dt.fingerprints[0]) != 0  # the pinned slot is exempt
    with pytest.raises(ValueError, match="capacity"):
        window_array.update_tenants(cfg, dcfg, window_array.init(cfg, k + 1, e, device="cpu"), dt, kt,
                                    _ids_t(ids), _t(w))


def _estimate_walk(k, n_steps, seed, spike_at, spike_tenant):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 5000.0, k)
    out = []
    for t in range(n_steps):
        est = base * (1.0 + 0.05 * rng.standard_normal(k))
        if t >= spike_at:
            est[spike_tenant] += 20000.0
        out.append(np.maximum(est, 0.0).astype(np.float32))
    return out


def test_anomaly_step_top_alerts_and_merge_match_jax():
    """Baselines to rtol 1e-6. XLA contracts some multiply-adds into FMAs,
    so a baseline of ~4e3 may differ by one float32 ulp (4.9e-4); that moves
    a score z = residual / deviation (deviation ~3e2) by ~2e-6 absolute,
    hence the scores' absolute floor of 1e-5 beside rtol 1e-6."""
    k = 64
    bcfg = anomaly.AnomalyConfig(warmup=4, min_weight=500.0, cusum_h=6.0)
    bcfg_j = janom.AnomalyConfig(warmup=4, min_weight=500.0, cusum_h=6.0)
    bj, bt = janom.init(k), anomaly.init(k, device="cpu")
    flagged = False
    for est in _estimate_walk(k, 14, seed=3, spike_at=9, spike_tenant=11):
        bj, sj = janom.step(bcfg_j, bj, jnp.asarray(est))
        bt, st = anomaly.step(bcfg, bt, est)
        for name in ("mean", "dev"):
            np.testing.assert_allclose(getattr(bt, name).numpy(), np.asarray(getattr(bj, name)), rtol=1e-6)
        np.testing.assert_allclose(bt.score.numpy(), np.asarray(bj.score), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-5)
        assert int(bt.n_steps) == int(bj.n_steps)
        alerts = anomaly.top_alerts(bcfg, st, n=5)
        want = janom.top_alerts(bcfg_j, sj, n=5)
        assert [s for s, _ in alerts] == [s for s, _ in want]
        np.testing.assert_allclose([v for _, v in alerts], [v for _, v in want], rtol=1e-6, atol=1e-5)
        flagged |= any(s == 11 for s, _ in alerts)
    assert flagged
    other_j, other_t = janom.init(k), anomaly.init(k, device="cpu")
    mj, mt = janom.merge(bj, other_j), anomaly.merge(bt, other_t)
    for name in ("mean", "dev"):
        np.testing.assert_allclose(getattr(mt, name).numpy(), np.asarray(getattr(mj, name)), rtol=1e-6)
    np.testing.assert_allclose(mt.score.numpy(), np.asarray(mj.score), rtol=1e-6, atol=1e-5)
    assert int(mt.n_steps) == int(mj.n_steps)
    with pytest.raises(ValueError, match="matching"):
        anomaly.merge(bt, anomaly.init(k + 1, device="cpu"))
    with pytest.raises(ValueError, match="warmup"):
        anomaly.AnomalyConfig(warmup=0)


def _monitor_pair(cfg_j, cfg, capacity, e, evict_after):
    mon_j = jmon.WindowMonitor.for_capacity(cfg_j, capacity, e, evict_after=evict_after)
    mon = monitor.WindowMonitor.for_capacity(cfg, capacity, e, evict_after=evict_after, device="cpu")
    return mon_j, mon


def test_window_monitor_matches_jax(jax_registry_off):
    cfg_j, cfg = JCfg(m=64, b=8, seed=61), SketchConfig(m=64, b=8, seed=61)
    mon_j, mon = _monitor_pair(cfg_j, cfg, 16, 3, evict_after=2)
    sj, st = mon_j.init(), mon.init()
    for ep in range(5):
        tenants, _ = _tenants(400, seed=ep, n_pool=max(3, 20 - 5 * ep))
        _, ids, w, mask = _keyed(400, 16, seed=80 + ep, n_ids=300)
        sj = mon_j.update(sj, jkd.split_uint64(tenants), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
        st = mon.update(st, key_directory.split_uint64(tenants, "cpu"), _ids_t(ids), _t(w), mask=_t(mask))
        _assert_window(st.window, sj.window)
        assert int(st.n_seen) == int(sj.n_seen)
        np.testing.assert_allclose(mon.estimate(st).numpy(), np.asarray(mon_j.estimate(sj)), **CHAT_TOL)
        np.testing.assert_allclose(mon.estimate(st, w=2).numpy(), np.asarray(mon_j.estimate(sj, w=2)), **MLE_TOL)
        got, want = mon.metrics(st), mon_j.metrics(sj)
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5)
        sj, st = mon_j.rotate(sj), mon.rotate(st)
        _assert_window(st.window, sj.window)
        for name in jkd.DirectoryState._fields:
            np.testing.assert_array_equal(
                getattr(convert.to_numpy(st.directory), name), np.asarray(getattr(sj.directory, name))
            )
    # Ring-aligned merge of two monitors on the same clock.
    sj2, st2 = mon_j.init(), mon.init()
    for _ in range(5):
        sj2, st2 = mon_j.rotate(sj2), mon.rotate(st2)
    tenants, _ = _tenants(300, seed=9)
    _, ids, w, _ = _keyed(300, 16, seed=90)
    sj2 = mon_j.update(sj2, jkd.split_uint64(tenants), jnp.asarray(ids), jnp.asarray(w))
    st2 = mon.update(st2, key_directory.split_uint64(tenants, "cpu"), _ids_t(ids), _t(w))
    mj, mt = mon_j.merge(sj, sj2), mon.merge(st, st2)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(mt.window, name).numpy(), np.asarray(getattr(mj.window, name)))
    np.testing.assert_allclose(mt.window.union_chats.numpy(), np.asarray(mj.window.union_chats), **MLE_TOL)
    assert int(mt.n_seen) == int(mj.n_seen)
    assert int(mt.directory.n_collisions) == int(mj.directory.n_collisions)
    with pytest.raises(ValueError, match="evict_after"):
        monitor.WindowMonitor.for_capacity(cfg, 16, 3, evict_after=-1, device="cpu")


def test_window_metrics_publish_what_the_jax_registry_would(jax_registry_off, port_registry_on):
    """The gauges WindowMonitor.metrics() publishes read back as the values
    the JAX publisher would set (``float`` of each returned scalar; the JAX
    registry itself must stay off on this jax)."""
    cfg_j, cfg = JCfg(m=64, b=8, seed=5), SketchConfig(m=64, b=8, seed=5)
    mon_j, mon = _monitor_pair(cfg_j, cfg, 8, 3, evict_after=1)
    sj, st = mon_j.init(), mon.init()
    for ep in range(3):
        tenants, _ = _tenants(300, seed=50 + ep)
        _, ids, w, mask = _keyed(300, 8, seed=70 + ep, n_ids=200)
        sj = mon_j.update(sj, jkd.split_uint64(tenants), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
        st = mon.update(st, key_directory.split_uint64(tenants, "cpu"), _ids_t(ids), _t(w), mask=_t(mask))
        if ep < 2:
            sj, st = mon_j.rotate(sj), mon.rotate(st)
    want = mon_j.metrics(sj)
    got = mon.metrics(st)
    assert "tenant_window_weight" in want and "tenant_window_epoch" in want
    for name in want:
        series = port_metrics.gauge(name, labels=("monitor",)).labels(monitor="window")
        np.testing.assert_allclose(series.value, float(want[name]), rtol=1e-5)
    assert port_metrics.gauge("tenant_window_epoch", labels=("monitor",)).labels(monitor="window").value == 2
    # The returned epoch does not move with the ring's in-place clock.
    mon.rotate(st)
    assert int(got["tenant_window_epoch"]) == 2


def test_convert_round_trip_carries_on_like_jax(jax_registry_off):
    cfg_j, cfg = JCfg(m=64, b=8, seed=6), SketchConfig(m=64, b=8, seed=6)
    mon_j, mon = _monitor_pair(cfg_j, cfg, 8, 3, evict_after=2)
    tenants, _ = _tenants(200, seed=1)
    _, ids, w, _ = _keyed(200, 8, seed=2)
    sj = mon_j.update(mon_j.init(), jkd.split_uint64(tenants), jnp.asarray(ids), jnp.asarray(w))
    sj = mon_j.rotate(sj)
    st = convert.from_jax_numpy(sj, device="cpu")
    assert type(st) is monitor.WindowMonitorState and type(st.window) is WindowArrayState
    assert st.window.head.dtype == torch.int32 and st.window.head.dim() == 0
    tenants, _ = _tenants(200, seed=3)
    _, ids, w, mask = _keyed(200, 8, seed=4)
    sj = mon_j.update(sj, jkd.split_uint64(tenants), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
    st = mon.update(st, key_directory.split_uint64(tenants, "cpu"), _ids_t(ids), _t(w), mask=_t(mask))
    sj, st = mon_j.rotate(sj), mon.rotate(st)
    _assert_window(st.window, sj.window)
    back = convert.to_numpy(st)
    for name in INT_FIELDS:
        assert getattr(back.window, name).dtype == np.asarray(getattr(sj.window, name)).dtype
    assert back.directory.fingerprints.dtype == np.uint32
    bj = janom.step(janom.AnomalyConfig(), janom.init(8), sj.window.union_chats)[0]
    bt = convert.from_jax_numpy(bj, device="cpu")
    assert type(bt) is anomaly.AnomalyBankState
    for a, b in zip(convert.to_numpy(bt), bj):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_windowed_alerts_scenario_on_the_port_cpu_path():
    """``examples/windowed_alerts.py`` at its own sizes on the port's CPU
    path: the flood tenant surfaces in the top-5 alerts from its epoch on,
    and no baseline tenant ever alerts."""
    cfg = SketchConfig(m=64, b=8, seed=11)
    capacity, n_tenants, n_flows = 2**14, 48, 20000
    n_epochs, window = 16, 6
    packets_per_epoch = 30000
    spike_epoch, spike_packets = 13, 4000
    mon = monitor.WindowMonitor.for_capacity(cfg, capacity, window, evict_after=window, device="cpu")
    bcfg = anomaly.AnomalyConfig(warmup=window + 2, min_weight=2000.0, cusum_h=8.0)
    rng = np.random.default_rng(7)
    tenant_ids = rng.integers(0, 2**64, n_tenants, dtype=np.uint64)
    spike_tenant = 11
    keys, flows, sizes, _ = synthetic.netflow_keyed(n_tenants, n_flows, n_epochs * packets_per_epoch, seed=3)
    st, bank = mon.init(), anomaly.init(capacity, device="cpu")
    slots = key_directory.route_slots(mon.dcfg, key_directory.split_uint64(tenant_ids, "cpu")).numpy()
    spike_slot = int(slots[spike_tenant])
    spiked = false_positive = False
    for ep in range(n_epochs):
        sl = slice(ep * packets_per_epoch, (ep + 1) * packets_per_epoch)
        ep_keys, ep_flows, ep_sizes = keys[sl], flows[sl], sizes[sl]
        if ep == spike_epoch:
            ep_keys = np.concatenate([ep_keys, np.full(spike_packets, spike_tenant, np.int32)])
            ep_flows = np.concatenate([ep_flows, rng.integers(0, 2**32, spike_packets, dtype=np.uint32)])
            ep_sizes = np.concatenate([
                ep_sizes, np.clip(rng.lognormal(6.0, 1.0, spike_packets), 40, 65535).astype(np.float32)
            ])
        st = mon.update(st, key_directory.split_uint64(tenant_ids[ep_keys], "cpu"), _ids_t(ep_flows), _t(ep_sizes))
        bank, scores = anomaly.step(bcfg, bank, mon.estimate(st))
        alert_slots = [s for s, _ in anomaly.top_alerts(bcfg, scores, n=5)]
        spiked |= ep >= spike_epoch and spike_slot in alert_slots
        false_positive |= any(s != spike_slot for s in alert_slots)
        st = mon.rotate(st)
    assert spiked, "the flood tenant was never among the top-5 alerts"
    assert not false_positive, "a baseline tenant alerted"
    assert int(st.n_seen) == n_epochs * packets_per_epoch + spike_packets
