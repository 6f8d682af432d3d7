"""The port's main path against the JAX package, end to end, on the CPU.

Same inputs (made from a seed with numpy) through both packages over
several batches with duplicates, masks and zero weights. Integer state
(registers, histograms, directory) bit for bit; running estimates (chats)
to rtol 1e-5, atol 1e-6 (``tests/test_dyn_array.py``'s tolerance: float32
sums in another order); MLEs to rtol 1e-5 against the JAX newton solve and
within LUT_RTOL / ATOL_FLOOR of the float64 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SketchConfig as JCfg
from repro.core import dyn_array as jda
from repro.core import estimators as jest
from repro.core import key_directory as jkd
from repro.core import qsketch as jq
from repro.core import qsketch_dyn as jqd
from repro.core.types import DynArrayState as JDynArrayState
from repro.obs import metrics as jmetrics
from repro.sketchstream import monitor as jmon
from repro_torch import convert
from repro_torch.core import (
    SketchConfig, dyn_array, estimation, estimators, key_directory, qsketch, qsketch_dyn,
)
from repro_torch.core.types import DynArrayState
from repro_torch.obs import metrics as port_metrics
from repro_torch.sketchstream import monitor

CHAT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def jax_registry_off():
    """The JAX monitors' metrics() reach ``jax.core.trace_state_clean``
    (gone in this jax) only while the JAX registry is on: switch it off for
    the test and restore the process-wide state afterwards."""
    was = jmetrics.enabled()
    jmetrics.configure(enabled=False)
    yield
    jmetrics.configure(enabled=was)


def _batches(n_batches, batch, seed, k=None, n_ids=None):
    """Batches with in-batch duplicates, a mask, zero and negative weights."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, n_ids or batch, dtype=np.uint32)
    out = []
    for _ in range(n_batches):
        ids = pool[rng.integers(0, len(pool), batch)]
        w = (rng.gamma(1.0, 2.0, batch) + 1e-4).astype(np.float32)
        w[rng.random(batch) < 0.05] = 0.0
        w[rng.random(batch) < 0.02] = -1.0
        mask = rng.random(batch) > 0.1
        keys = None if k is None else rng.integers(0, k, batch).astype(np.int32)
        out.append((keys, ids, w, mask))
    return out


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _ids_t(ids):
    return _t(ids.astype(np.int64))


def _assert_dyn_array(port, jax_state):
    np.testing.assert_array_equal(port.regs.numpy(), np.asarray(jax_state.regs))
    np.testing.assert_array_equal(port.hists.numpy(), np.asarray(jax_state.hists))
    np.testing.assert_allclose(port.chats.numpy(), np.asarray(jax_state.chats), **CHAT_TOL)


def test_qsketch_update_estimate_merge():
    cfg_j, cfg = JCfg(m=128, b=8, seed=2), SketchConfig(m=128, b=8, seed=2)
    sj, st = jq.init(cfg_j), qsketch.init(cfg, device="cpu")
    for _, ids, w, mask in _batches(3, 300, seed=1):
        w = np.abs(w)  # full QSketch takes w >= 0
        sj = jq.update(cfg_j, sj, jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
        st = qsketch.update(cfg, st, _ids_t(ids), _t(w), mask=_t(mask))
        np.testing.assert_array_equal(st.regs.numpy(), np.asarray(sj.regs))
    np.testing.assert_allclose(
        float(qsketch.estimate(cfg, st)), float(jq.estimate(cfg_j, sj)), rtol=1e-5
    )
    hist = estimators.histogram(cfg, st.regs)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jest.histogram(cfg_j, sj.regs)))
    np.testing.assert_allclose(
        float(estimators.qsketch_init(cfg, hist)), float(jest.qsketch_init(cfg_j, jnp.asarray(hist.numpy()))),
        rtol=1e-6,
    )
    chat, std, ok = qsketch.estimate_with_ci(cfg, st)
    chat_j, std_j, ok_j = jq.estimate_with_ci(cfg_j, sj)
    np.testing.assert_allclose([float(chat), float(std)], [float(chat_j), float(std_j)], rtol=1e-5)
    assert bool(ok) == bool(ok_j)
    assert abs(float(chat) - jest.mle_numpy(cfg_j, np.asarray(sj.regs))) <= (
        estimation.LUT_RTOL * float(chat) + estimation.ATOL_FLOOR
    )
    other = qsketch.init(cfg, device="cpu")
    other = qsketch.update(cfg, other, torch.arange(50), torch.ones(50))
    other_j = jq.update(cfg_j, jq.init(cfg_j), jnp.arange(50, dtype=jnp.uint32), jnp.ones(50))
    np.testing.assert_array_equal(
        qsketch.merge(st, other).regs.numpy(), np.asarray(jq.merge(sj, other_j).regs)
    )


def test_qsketch_dyn_batch_and_scan_match_jax():
    cfg_j, cfg = JCfg(m=64, b=8, seed=5), SketchConfig(m=64, b=8, seed=5)
    bj, sj = jqd.init(cfg_j), jqd.init(cfg_j)
    bt, stn = qsketch_dyn.init(cfg, "cpu"), qsketch_dyn.init(cfg, "cpu")
    for _, ids, w, mask in _batches(3, 120, seed=2):
        args_j = (jnp.asarray(ids), jnp.asarray(w))
        args_t = (_ids_t(ids), _t(w))
        bj = jqd.update_batch(cfg_j, bj, *args_j, mask=jnp.asarray(mask))
        bt = qsketch_dyn.update_batch(cfg, bt, *args_t, mask=_t(mask))
        sj = jqd.update_scan(cfg_j, sj, *args_j, mask=jnp.asarray(mask))
        stn = qsketch_dyn.update_scan(cfg, stn, *args_t, mask=_t(mask))
        for port, ref in ((bt, bj), (stn, sj)):
            np.testing.assert_array_equal(port.regs.numpy(), np.asarray(ref.regs))
            np.testing.assert_array_equal(port.hist.numpy(), np.asarray(ref.hist))
            np.testing.assert_allclose(float(port.chat), float(ref.chat), **CHAT_TOL)
    np.testing.assert_allclose(
        float(qsketch_dyn.estimate_mle(cfg, bt)), float(jqd.estimate_mle(cfg_j, bj)), rtol=1e-5, atol=1e-30
    )
    mt, mj = qsketch_dyn.merge(cfg, bt, stn), jqd.merge(cfg_j, bj, sj)
    np.testing.assert_array_equal(mt.regs.numpy(), np.asarray(mj.regs))
    np.testing.assert_array_equal(mt.hist.numpy(), np.asarray(mj.hist))
    np.testing.assert_allclose(float(mt.chat), float(mj.chat), rtol=1e-5, atol=1e-30)
    assert float(qsketch_dyn.estimate(bt)) == float(bt.chat)


def test_dyn_array_update_batch_matches_jax():
    k = 33
    cfg_j, cfg = JCfg(m=96, b=8, seed=7), SketchConfig(m=96, b=8, seed=7)
    sj, st = jda.init(cfg_j, k), dyn_array.init(cfg, k, device="cpu")
    for keys, ids, w, mask in _batches(4, 257, seed=3, k=k, n_ids=120):
        sj = jda.update_batch(cfg_j, sj, jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
        st = dyn_array.update_batch(cfg, st, _t(keys), _ids_t(ids), _t(w), mask=_t(mask))
        _assert_dyn_array(st, sj)
    # ~31 elements per row leave registers untouched, where the histogram
    # MLE collapses to ~0; a dense phase on keys 0-2 (~2000 distinct
    # elements per row at m = 96) touches every register of those rows so
    # the MLE comparisons below hold nonzero values.
    rng = np.random.default_rng(17)
    for _ in range(3):
        keys = rng.integers(0, 3, 2000).astype(np.int32)
        ids = rng.integers(0, 2**32, 2000, dtype=np.uint32)
        w = (rng.gamma(1.0, 2.0, 2000) + 1e-4).astype(np.float32)
        sj = jda.update_batch(cfg_j, sj, jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w))
        st = dyn_array.update_batch(cfg, st, _t(keys), _ids_t(ids), _t(w))
        _assert_dyn_array(st, sj)
    assert (st.regs[:3] > cfg.r_min).all()
    np.testing.assert_array_equal(
        dyn_array.rebuild_hists(cfg, st.regs).numpy(), st.hists.numpy()
    )
    # The anytime read, and the per-row MLE through both ported solvers.
    assert dyn_array.estimate_all(st) is st.chats
    mle_j = np.asarray(jda.estimate_mle_all(cfg_j, sj))
    assert (mle_j[:3] > 1000).all()
    mle_t = dyn_array.estimate_mle_all(cfg, st).numpy()
    np.testing.assert_allclose(mle_t, mle_j, rtol=1e-5, atol=estimation.ATOL_FLOOR)
    fused = dyn_array.estimate_mle_all(cfg, st, solver="fused").numpy()
    np.testing.assert_allclose(fused, mle_j, rtol=estimation.LUT_RTOL, atol=estimation.ATOL_FLOOR)
    with pytest.raises(ValueError, match="not ported"):
        dyn_array.estimate_mle_all(cfg, st, solver="lut")


def test_dyn_array_merge_matches_jax():
    k = 4  # ~1000 elements per row at m = 64: rows fully touched, MLEs far from 0
    cfg_j, cfg = JCfg(m=64, b=8, seed=8), SketchConfig(m=64, b=8, seed=8)
    states = []
    for seed in (4, 5):
        keys, ids, w, mask = _batches(1, 4000, seed=seed, k=k, n_ids=3000)[0]
        sj = jda.update_batch(cfg_j, jda.init(cfg_j, k), jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w))
        st = dyn_array.update_batch(cfg, dyn_array.init(cfg, k, "cpu"), _t(keys), _ids_t(ids), _t(w))
        states.append((sj, st))
    mj = jda.merge(cfg_j, states[0][0], states[1][0])
    mt = dyn_array.merge(cfg, states[0][1], states[1][1])
    np.testing.assert_array_equal(mt.regs.numpy(), np.asarray(mj.regs))
    np.testing.assert_array_equal(mt.hists.numpy(), np.asarray(mj.hists))
    np.testing.assert_allclose(mt.chats.numpy(), np.asarray(mj.chats), rtol=1e-5)
    assert (mt.chats.numpy() > 100).all()


def _tenants(batch, seed):
    rng = np.random.default_rng(seed)
    tenant_pool = rng.integers(0, 2**64, 40, dtype=np.uint64)
    tenant_pool[0] = 2**64 - 1
    return tenant_pool[rng.integers(0, len(tenant_pool), batch)], tenant_pool


def test_update_tenants_and_directory_match_jax():
    k = 64
    cfg_j, cfg = JCfg(m=64, b=8, seed=9), SketchConfig(m=64, b=8, seed=9)
    _, pool = _tenants(1, seed=0)
    pinned = (int(pool[3]), int(pool[5]))
    dcfg_j = jkd.DirectoryConfig(capacity=k, seed=3, pinned=pinned)
    dcfg = key_directory.DirectoryConfig(capacity=k, seed=3, pinned=pinned)
    sj, dj = jda.init(cfg_j, k), jkd.init(dcfg_j)
    st, dt = dyn_array.init(cfg, k, "cpu"), key_directory.init(dcfg, "cpu")
    for i, (_, ids, w, mask) in enumerate(_batches(3, 300, seed=6, n_ids=200)):
        tenants, _ = _tenants(300, seed=10 + i)
        kj = jkd.split_uint64(tenants)
        kt = key_directory.split_uint64(tenants, device="cpu")
        sj, dj = jda.update_tenants(cfg_j, dcfg_j, sj, dj, kj, jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
        st, dt = dyn_array.update_tenants(cfg, dcfg, st, dt, kt, _ids_t(ids), _t(w), mask=_t(mask))
        _assert_dyn_array(st, sj)
        np.testing.assert_array_equal(
            key_directory.route_slots(dcfg, kt).numpy(), np.asarray(jkd.route_slots(dcfg_j, kj))
        )
        port_dir = convert.to_numpy(dt)
        for name in jkd.DirectoryState._fields:
            np.testing.assert_array_equal(getattr(port_dir, name), np.asarray(getattr(dj, name)))
    assert float(key_directory.occupancy(dt)) == float(jkd.occupancy(dj))
    assert float(key_directory.collision_rate(dt)) == float(jkd.collision_rate(dj))
    merged = convert.to_numpy(key_directory.merge(dt, key_directory.init(dcfg, "cpu")))
    merged_j = jkd.merge(dj, jkd.init(dcfg_j))
    for name in jkd.DirectoryState._fields:
        np.testing.assert_array_equal(getattr(merged, name), np.asarray(getattr(merged_j, name)))


def test_dyn_array_monitor_matches_jax(jax_registry_off):
    cfg_j, cfg = JCfg(m=64, b=8, seed=1), SketchConfig(m=64, b=8, seed=1)
    mon_j = jmon.DynArrayMonitor.for_capacity(cfg_j, 128)
    mon = monitor.DynArrayMonitor.for_capacity(cfg, 128, device="cpu")
    sj, st = mon_j.init(), mon.init()
    for i, (_, ids, w, mask) in enumerate(_batches(3, 256, seed=11, n_ids=150)):
        tenants, _ = _tenants(256, seed=20 + i)
        sj = mon_j.update(sj, jkd.split_uint64(tenants), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
        st = mon.update(st, key_directory.split_uint64(tenants, "cpu"), _ids_t(ids), _t(w), mask=_t(mask))
    _assert_dyn_array(st, sj)
    assert int(st.n_seen) == int(sj.n_seen)
    np.testing.assert_allclose(mon.estimate(st).numpy(), np.asarray(mon_j.estimate(sj)), **CHAT_TOL)
    got, want = mon.metrics(st), mon_j.metrics(sj)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5)
    # Merge with a second monitor's state (register max + MLE re-estimate).
    sj2, st2 = mon_j.init(), mon.init()
    tenants, _ = _tenants(256, seed=30)
    _, ids, w, _ = _batches(1, 256, seed=12)[0]
    sj2 = mon_j.update(sj2, jkd.split_uint64(tenants), jnp.asarray(ids), jnp.asarray(np.abs(w)))
    st2 = mon.update(st2, key_directory.split_uint64(tenants, "cpu"), _ids_t(ids), _t(np.abs(w)))
    mj, mt = mon_j.merge(sj, sj2), mon.merge(st, st2)
    np.testing.assert_array_equal(mt.regs.numpy(), np.asarray(mj.regs))
    np.testing.assert_array_equal(mt.hists.numpy(), np.asarray(mj.hists))
    np.testing.assert_allclose(mt.chats.numpy(), np.asarray(mj.chats), rtol=1e-5, atol=estimation.ATOL_FLOOR)
    assert int(mt.n_seen) == int(mj.n_seen)
    assert int(mt.directory.n_collisions) == int(mj.directory.n_collisions)


@pytest.fixture
def port_registry_on():
    """Switch the port's registry on and restore its earlier state."""
    was = port_metrics.enabled()
    port_metrics.configure(enabled=True)
    yield
    port_metrics.configure(enabled=was)


def test_tenant_metrics_publish_what_the_jax_registry_would(jax_registry_off, port_registry_on):
    """The gauges DynArrayMonitor.metrics() publishes read back as the JAX
    registry's values for the same call. The JAX publisher sets each gauge
    to ``float`` of the returned scalar but cannot run on this jax (its
    registry must stay off), so its values are taken from the returned dict."""
    cfg_j, cfg = JCfg(m=64, b=8, seed=5), SketchConfig(m=64, b=8, seed=5)
    mon_j = jmon.DynArrayMonitor.for_capacity(cfg_j, 16)
    mon = monitor.DynArrayMonitor.for_capacity(cfg, 16, device="cpu")
    sj, st = mon_j.init(), mon.init()
    # 40 tenants into 16 slots: the second batch collides with the first's claims.
    for i, (_, ids, w, mask) in enumerate(_batches(2, 300, seed=15, n_ids=200)):
        tenants, _ = _tenants(300, seed=50 + i)
        sj = mon_j.update(sj, jkd.split_uint64(tenants), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
        st = mon.update(st, key_directory.split_uint64(tenants, "cpu"), _ids_t(ids), _t(w), mask=_t(mask))
    want = mon_j.metrics(sj)
    mon.metrics(st)
    for name in want:
        got = port_metrics.gauge(name, labels=("monitor",)).labels(monitor="dyn_array").value
        np.testing.assert_allclose(got, float(want[name]), rtol=1e-5)
    assert float(want["tenant_collision_rate"]) > 0
    # A disabled registry keeps its last values.
    port_metrics.configure(enabled=False)
    mon.metrics(monitor.DynArrayMonitorState(*st[:4], n_seen=st.n_seen + 1))
    seen = port_metrics.gauge("tenant_elements_seen", labels=("monitor",)).labels(monitor="dyn_array")
    assert seen.value == float(want["tenant_elements_seen"])


def test_scalar_monitor_matches_jax():
    cfg_j, cfg = JCfg(m=128, b=8, seed=4), SketchConfig(m=128, b=8, seed=4)
    sj, st = jmon.init(cfg_j), monitor.init(cfg, device="cpu")
    for _, ids, w, mask in _batches(3, 200, seed=13):
        ids2, w2, m2 = ids.reshape(20, 10), np.abs(w).reshape(20, 10), mask.reshape(20, 10)
        sj = jmon.update(cfg_j, sj, jnp.asarray(ids2), jnp.asarray(w2), mask=jnp.asarray(m2))
        st = monitor.update(cfg, st, _ids_t(ids2), _t(w2), mask=_t(m2))
    st = monitor.update(cfg, st, torch.arange(30))  # weight 1.0 when not given
    sj = jmon.update(cfg_j, sj, jnp.arange(30, dtype=jnp.uint32))
    np.testing.assert_array_equal(st.regs.numpy(), np.asarray(sj.regs))
    assert int(st.n_seen) == int(sj.n_seen)
    np.testing.assert_allclose(float(monitor.estimate(cfg, st)), float(jmon.estimate(cfg_j, sj)), rtol=1e-5)
    mt, mj = monitor.merge(cfg, st, st), jmon.merge(cfg_j, sj, sj)
    np.testing.assert_array_equal(mt.regs.numpy(), np.asarray(mj.regs))
    assert int(mt.n_seen) == int(mj.n_seen)


def test_convert_round_trip_carries_on_like_jax(jax_registry_off):
    """A JAX state converted into the port and carried on gives the JAX
    package's next state; converted back it is a valid JAX state again."""
    cfg_j, cfg = JCfg(m=64, b=8, seed=6), SketchConfig(m=64, b=8, seed=6)
    mon_j = jmon.DynArrayMonitor.for_capacity(cfg_j, 32)
    mon = monitor.DynArrayMonitor.for_capacity(cfg, 32, device="cpu")
    batches = _batches(2, 200, seed=14, n_ids=120)
    tenants = [_tenants(200, seed=40 + i)[0] for i in range(2)]
    sj = mon_j.update(mon_j.init(), jkd.split_uint64(tenants[0]), jnp.asarray(batches[0][1]), jnp.asarray(batches[0][2]))
    st = convert.from_jax_numpy(sj, device="cpu")
    assert type(st) is monitor.DynArrayMonitorState
    assert st.directory.fingerprints.dtype == torch.int64
    _, ids, w, mask = batches[1]
    sj = mon_j.update(sj, jkd.split_uint64(tenants[1]), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
    st = mon.update(st, key_directory.split_uint64(tenants[1], "cpu"), _ids_t(ids), _t(w), mask=_t(mask))
    _assert_dyn_array(st, sj)
    back = convert.to_numpy(st)
    assert back.directory.fingerprints.dtype == np.uint32
    for name in ("fingerprints", "n_routed", "n_collisions", "last_touch"):
        np.testing.assert_array_equal(getattr(back.directory, name), np.asarray(getattr(sj.directory, name)))
    # Back into the JAX package and one more batch on both sides.
    ja = JDynArrayState(*(jnp.asarray(x) for x in (back.regs, back.hists, back.chats)))
    keys = np.random.default_rng(1).integers(0, 32, 200).astype(np.int32)
    ja = jda.update_batch(cfg_j, ja, jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(np.abs(w)))
    pa = dyn_array.update_batch(
        cfg, DynArrayState(st.regs, st.hists, st.chats), _t(keys), _ids_t(ids), _t(np.abs(w))
    )
    _assert_dyn_array(pa, ja)
    for name, jstate in (("QSketchState", jq.init(cfg_j)), ("DynState", jqd.init(cfg_j))):
        port = convert.from_jax_numpy(jstate, device="cpu")
        assert type(port).__name__ == name
        for a, b in zip(convert.to_numpy(port), jstate):
            np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(TypeError):
        convert.from_jax_numpy((np.zeros(3),), device="cpu")


def test_readme_ten_lines_run_on_the_port():
    cfg = SketchConfig(m=256, b=8, seed=1)
    mon = monitor.DynArrayMonitor.for_capacity(cfg, capacity=4096, device="cpu")
    state = mon.init()
    tenants = torch.tensor([17, 17, 42])
    ids = torch.tensor([1001, 1002, 1001])
    weights = torch.tensor([1.0, 2.5, 4.0])
    state = mon.update(state, tenants, ids, weights)
    per_tenant = mon.estimate(state)
    slots = key_directory.route_slots(mon.dcfg, tenants)
    assert per_tenant.shape == (4096,)
    assert float(per_tenant[slots[0]]) > 0 and float(per_tenant[slots[2]]) > 0
    assert int(state.n_seen) == 3


def test_padded_duplicate_never_shadows_a_live_row():
    """A masked or zero-weight row sorting ahead of a live row with the same
    (key, id) must not take its place in the dedup (the JAX package's fixed
    ordering contract): both packages keep the live row's weight."""
    cfg_j, cfg = JCfg(m=64, b=8, seed=2), SketchConfig(m=64, b=8, seed=2)
    ids = np.array([7, 7, 7, 9, 9, 11], np.uint32)
    keys = np.array([1, 1, 1, 0, 0, 1], np.int32)
    w = np.array([0.0, 3.0, 5.0, 2.0, 2.0, 1.0], np.float32)
    mask = np.array([True, True, True, False, True, True])
    sj = jda.update_batch(cfg_j, jda.init(cfg_j, 2), jnp.asarray(keys), jnp.asarray(ids),
                          jnp.asarray(w), mask=jnp.asarray(mask))
    st = dyn_array.update_batch(cfg, dyn_array.init(cfg, 2, "cpu"), _t(keys), _ids_t(ids), _t(w), mask=_t(mask))
    _assert_dyn_array(st, sj)
    assert (st.chats.numpy() > 0).all()
    dj = jqd.update_batch(cfg_j, jqd.init(cfg_j), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
    dt = qsketch_dyn.update_batch(cfg, qsketch_dyn.init(cfg, "cpu"), _ids_t(ids), _t(w), mask=_t(mask))
    np.testing.assert_array_equal(dt.regs.numpy(), np.asarray(dj.regs))
    np.testing.assert_allclose(float(dt.chat), float(dj.chat), **CHAT_TOL)
