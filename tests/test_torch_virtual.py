"""The port's register-sharing virtual tier (kernel K8's path, with K3 on the
hot rows) against the JAX package on the CPU.

Same inputs, made from a seed with numpy, through both packages. Integer
state bit for bit: the pool, its full histogram, ``n_tail``, the hot tier's
registers and histograms, K8's (p, y) against the interpret-mode Pallas
entry, the directory's slots. Floats (ROADMAP's parity contract): hot
``chats`` and ``w_tail`` rtol 1e-5 (the JAX package's own oracle test
compares ``w_tail`` bit for bit and meets a 1-ulp difference between its
jnp path and its oracle on this tree); the virtual estimators on identical
histograms rtol 1e-5.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SketchConfig as JCfg
from repro.core import estimation as jest
from repro.core import key_directory as jkd
from repro.core import virtual_dyn_array as jv
from repro.core.virtual_dyn_array import VirtualConfig as JVCfg
from repro.kernels import ops as jops
from repro.kernels import virtual_pool_update as jk8
from repro.obs import metrics as jmetrics
from repro.sketchstream import monitor as jmon
from repro_torch import convert
from repro_torch.core import SketchConfig, VirtualConfig, estimation, key_directory
from repro_torch.core import virtual_dyn_array as vda
from repro_torch.core.types import VirtualDynArrayState
from repro_torch.kernels import ops, ref
from repro_torch.sketchstream import monitor

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_registry_off():
    """The JAX ops fronts and monitors reach ``jax.core.trace_state_clean``
    (gone in this jax) only while the JAX registry is on: switch it off for
    the test and restore the process-wide state afterwards."""
    was = jmetrics.enabled()
    jmetrics.configure(enabled=False)
    yield
    jmetrics.configure(enabled=was)


def _words(x):
    x = np.asarray(x, dtype=np.uint64)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32), (x >> np.uint64(32)).astype(np.uint32)


def _jpair(x):
    lo, hi = _words(x)
    return jnp.asarray(lo), jnp.asarray(hi)


def _tpair(x):
    lo, hi = _words(x)
    return torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(hi.astype(np.int64))


def _stream(n, tids, seed, *, degenerate=False):
    """n elements over the given tenants: 64-bit ids (with duplicates),
    U(0.5, 1.5) weights, a mask; with ``degenerate``, zero, negative and
    NaN weights too."""
    rng = np.random.default_rng(seed)
    tk = tids[rng.integers(0, len(tids), n)]
    pool = rng.integers(0, 1 << 63, max(n // 2, 1), dtype=np.uint64)
    ids = pool[rng.integers(0, len(pool), n)]
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    if degenerate:
        w[::13] = 0.0
        w[5::17] = -1.0
        w[7::19] = np.nan
    mask = rng.random(n) > 0.1
    return tk, ids, w, mask


def _configs(m_virtual=None, *, m=64, b=6, seed=11, pool_size=1 << 12, pinned=()):
    cfg_j, cfg = JCfg(m=m, b=b, seed=seed), SketchConfig(m=m, b=b, seed=seed)
    pinned = tuple(int(t) for t in pinned)
    return (cfg_j, JVCfg(pool_size=pool_size, m_virtual=m_virtual, pinned=pinned),
            cfg, VirtualConfig(pool_size=pool_size, m_virtual=m_virtual, pinned=pinned))


def _assert_state(st, sj, *, rtol=1e-5):
    """Port state against a JAX state: integer leaves bit for bit, floats to rtol."""
    for f in ("pool", "pool_hist", "n_tail"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)), err_msg=f)
    np.testing.assert_allclose(float(st.w_tail), float(sj.w_tail), rtol=rtol)
    np.testing.assert_array_equal(st.hot.regs.numpy(), np.asarray(sj.hot.regs))
    np.testing.assert_array_equal(st.hot.hists.numpy(), np.asarray(sj.hot.hists))
    np.testing.assert_allclose(st.hot.chats.numpy(), np.asarray(sj.hot.chats), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("m_virtual", [None, 96])
def test_k8_plain_matches_jax_padded_kernel(m_virtual):
    cfg = SketchConfig(m=64, b=6, seed=11)
    m_v, pool_size, salt_pool = m_virtual or cfg.m, 1 << 12, VirtualConfig(pool_size=1 << 12).salt_pool
    rng = np.random.default_rng(8)
    n = 700
    lo, hi, t_lo, t_hi = (rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(4))
    w = rng.uniform(0.5, 1.5, n).astype(np.float32) * np.float32(10.0) ** rng.integers(-30, 30, n)
    w[::13], w[5::17], w[7::19], w[9::23] = 0.0, -1.0, np.nan, np.inf
    with np.errstate(divide="ignore", invalid="ignore"):
        log2w = np.log2(w).astype(np.float32)
    bb = 128
    bp = -(-n // bb) * bb
    pad = lambda a, fill: np.concatenate([a, np.full(bp - n, fill, a.dtype)])[:, None]  # noqa: E731
    p_j, y_j = jk8.virtual_pool_route_padded(
        *(jnp.asarray(pad(a, 0)) for a in (lo, hi, t_lo, t_hi)), jnp.asarray(pad(log2w, -np.inf)),
        salt_g=cfg.salt_g, salt_h=cfg.salt_h, salt_pool=salt_pool, m=m_v, pool_size=pool_size,
        r_min=cfg.r_min, r_max=cfg.r_max, block_b=bb, interpret=True,
    )
    args = [torch.from_numpy(a.astype(np.int64)) for a in (lo, hi, t_lo, t_hi)] + [torch.from_numpy(log2w)]
    p, y = ref.virtual_pool_route_ref(*args, salt_g=cfg.salt_g, salt_h=cfg.salt_h, salt_pool=salt_pool,
                                      m=m_v, pool_size=pool_size, r_min=cfg.r_min, r_max=cfg.r_max)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_j)[:n, 0])
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_j)[:n, 0])
    assert (y.numpy() == cfg.r_max).any() and (y.numpy() == cfg.r_min).any()
    got = ops.virtual_pool_route_op(cfg, m_v, salt_pool, pool_size, *args)
    assert torch.equal(got[0], p) and torch.equal(got[1], y)
    with pytest.raises(TypeError, match="dtype"):
        ops.virtual_pool_route_op(cfg, m_v, salt_pool, pool_size, *args[:4], args[4].double())
    with pytest.raises(ValueError, match="shape"):
        ops.virtual_pool_route_op(cfg, m_v, salt_pool, pool_size, args[0][:5], *args[1:])


@pytest.mark.parametrize("m_virtual", [None, 96])
@pytest.mark.parametrize("masked", [False, True])
def test_update_matches_jax_and_reference(m_virtual, masked, jax_registry_off):
    rng = np.random.default_rng(5)
    tids = rng.integers(0, 1 << 63, 24, dtype=np.uint64)
    cfg_j, vj, cfg, vt = _configs(m_virtual, pinned=tids[:4])
    sj = sk = jv.init(cfg_j, vj)
    st = vda.init(cfg, vt, device="cpu")
    for i in range(3):  # from a warm state after the first batch
        tk, ids, w, mask = _stream(300, tids, seed=i, degenerate=True)
        mj, mt = (jnp.asarray(mask), torch.from_numpy(mask)) if masked else (None, None)
        sj = jv.update_tenants(cfg_j, vj, sj, _jpair(tk), _jpair(ids), jnp.asarray(w), mj)
        sk = jops.virtual_dyn_update_op(cfg_j, vj, sk, _jpair(tk), _jpair(ids), jnp.asarray(w), mj,
                                        interpret=True)
        want = vda.update_reference(cfg, vt, st, _tpair(tk), _tpair(ids), torch.from_numpy(w), mt)
        out = vda.update_tenants(cfg, vt, st, _tpair(tk), _tpair(ids), torch.from_numpy(w), mt)
        assert out.pool is st.pool  # updated in place
        st = out
        _assert_state(st, sj)
        _assert_state(st, sk)
        for f in ("pool", "pool_hist", "n_tail", "w_tail"):
            assert torch.equal(getattr(st, f), getattr(want, f)), f
        for a, b in zip(st.hot, want.hot):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert (st.hot.chats[:4] > 0).all() and int(st.n_tail) > 0


def test_pool_hist_invariant_load_factor_and_noise_floor():
    rng = np.random.default_rng(1)
    tids = rng.integers(0, 1 << 63, 40, dtype=np.uint64)
    cfg_j, vj, cfg, vt = _configs(pool_size=1 << 10, pinned=tids[:2])
    sj, st = jv.init(cfg_j, vj), vda.init(cfg, vt, device="cpu")
    assert int(st.pool_hist.sum()) == 1 << 10 and float(vda.pool_load_factor(st)) == 0.0
    for i in range(4):
        tk, ids, w, _ = _stream(400, tids, seed=10 + i)
        sj = jv.update_tenants(cfg_j, vj, sj, _jpair(tk), _jpair(ids), jnp.asarray(w))
        st = vda.update_tenants(cfg, vt, st, _tpair(tk), _tpair(ids), torch.from_numpy(w))
        assert torch.equal(st.pool_hist, vda.rebuild_pool_hist(cfg, st.pool))
        assert int(st.pool_hist.sum()) == 1 << 10
    _assert_state(st, sj)
    np.testing.assert_allclose(float(vda.pool_load_factor(st)), float(jv.pool_load_factor(sj)), rtol=1e-6)
    np.testing.assert_allclose(float(vda.noise_floor(cfg, vt, st)), float(jv.noise_floor(cfg_j, vj, sj)),
                               rtol=1e-5)
    assert 0.0 < float(vda.pool_load_factor(st)) < 1.0


def test_merge_matches_jax():
    rng = np.random.default_rng(2)
    tids = rng.integers(0, 1 << 63, 30, dtype=np.uint64)
    cfg_j, vj, cfg, vt = _configs(pinned=tids[:3])
    pairs = []
    for seed in (3, 4):
        tk, ids, w, _ = _stream(500, tids, seed=seed)
        sj = jv.update_tenants(cfg_j, vj, jv.init(cfg_j, vj), _jpair(tk), _jpair(ids), jnp.asarray(w))
        st = vda.update_tenants(cfg, vt, vda.init(cfg, vt, device="cpu"), _tpair(tk), _tpair(ids),
                                torch.from_numpy(w))
        pairs.append((sj, st))
    (aj, at), (bj, bt) = pairs
    mj, mt = jv.merge(cfg_j, vj, aj, bj), vda.merge(cfg, vt, at, bt)
    _assert_state(mt, mj)
    assert torch.equal(mt.pool_hist, vda.rebuild_pool_hist(cfg, mt.pool))
    with pytest.raises(ValueError, match="matching pools"):
        vda.merge(cfg, vt, at, vda.init(cfg, dataclasses.replace(vt, pool_size=1 << 11), device="cpu"))


@pytest.mark.parametrize("migrate", [False, True])
def test_promote_matches_jax(migrate):
    rng = np.random.default_rng(6)
    tids = rng.integers(0, 1 << 63, 16, dtype=np.uint64)
    cfg_j, vj, cfg, vt = _configs(pool_size=1 << 10)  # nothing pinned: the placeholder row goes
    tk, ids, w, _ = _stream(800, tids, seed=7)
    sj = jv.update_tenants(cfg_j, vj, jv.init(cfg_j, vj), _jpair(tk), _jpair(ids), jnp.asarray(w))
    st = vda.update_tenants(cfg, vt, vda.init(cfg, vt, device="cpu"), _tpair(tk), _tpair(ids),
                            torch.from_numpy(w))
    riser = int(tids[0])
    vj2, sj2 = jv.promote(cfg_j, vj, sj, riser, migrate=migrate)
    vt2, st2 = vda.promote(cfg, vt, st, riser, migrate=migrate)
    assert vt2.pinned == vj2.pinned == (riser,)
    _assert_state(st2, sj2)
    if migrate:
        assert float(st2.hot.chats[0]) > 0
    else:
        assert float(st2.hot.chats[0]) == 0.0
    # Traffic after promotion: the riser's row, bit for bit; estimates too.
    tk2, ids2, w2, _ = _stream(300, tids[:4], seed=8)
    sj2 = jv.update_tenants(cfg_j, vj2, sj2, _jpair(tk2), _jpair(ids2), jnp.asarray(w2))
    st2 = vda.update_tenants(cfg, vt2, st2, _tpair(tk2), _tpair(ids2), torch.from_numpy(w2))
    _assert_state(st2, sj2)
    np.testing.assert_allclose(vda.estimate_tenants(cfg, vt2, st2, _tpair(tids)).numpy(),
                               np.asarray(jv.estimate_tenants(cfg_j, vj2, sj2, _jpair(tids))), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="already pinned"):
        vda.promote(cfg, vt2, st2, riser)
    cfg_w, vt_w = SketchConfig(m=64, b=6, seed=11), VirtualConfig(pool_size=1 << 10, m_virtual=96)
    with pytest.raises(ValueError, match="m_virtual"):
        vda.promote(cfg_w, vt_w, vda.init(cfg_w, vt_w, device="cpu"), riser, migrate=True)


def test_virtual_estimators_on_identical_histograms():
    """The compound-Poisson solve, the pooled read and the cancellation
    against the JAX package on the same full histograms: untouched rows,
    singleton-loaded rows, moderately and heavily loaded rows."""
    cfg_j, cfg = JCfg(m=64, b=8, seed=0), SketchConfig(m=64, b=8, seed=0)
    rng = np.random.default_rng(3)
    rows = np.full((24, cfg.m), cfg.r_min, np.int8)
    for i in range(1, 24):
        n_touched = min(cfg.m, int(3 * i ** 1.4))
        at = rng.choice(cfg.m, n_touched, replace=False)
        rows[i, at] = rng.integers(-6, 3 + i // 3, n_touched)
    got = estimation.estimate_rows_virtual(cfg, torch.from_numpy(rows)).numpy()
    want = np.asarray(jest.estimate_rows_virtual(cfg_j, jnp.asarray(rows)))
    assert got[0] == 0.0 and (got[1:] > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    hists = np.stack([np.bincount(r.astype(np.int64) - cfg.r_min, minlength=cfg.num_bins) for r in rows])
    hists = hists.astype(np.int32)
    np.testing.assert_allclose(estimation.estimate_hists_virtual(cfg, torch.from_numpy(hists)).numpy(),
                               np.asarray(jest.estimate_hists_virtual(cfg_j, jnp.asarray(hists))), rtol=1e-5)
    # Touched slots at values -126 .. -88 (loads of about 2^-100: the
    # likelihood's saturation cliff lies inside the grid), then at -8 .. 7.
    for pool_size, lo_v, hi_v in ((1 << 12, -126, -87), (1 << 12, -8, 8), (1 << 20, -8, 8)):
        pool_hist = np.zeros(cfg.num_bins, np.int32)
        pool_hist[lo_v - cfg.r_min : hi_v - cfg.r_min] = rng.integers(0, pool_size // 200, hi_v - lo_v)
        pool_hist[0] = pool_size - pool_hist.sum()
        a = float(estimation.estimate_pool_hist(cfg, torch.from_numpy(pool_hist), pool_size))
        b = float(jest.estimate_pool_hist(cfg_j, jnp.asarray(pool_hist), pool_size))
        np.testing.assert_allclose(a, b, rtol=1e-5)
        c = estimation.cancel_pool_noise(cfg, torch.from_numpy(got), torch.tensor(np.float32(a)), pool_size)
        d = jest.cancel_pool_noise(cfg_j, jnp.asarray(want), jnp.float32(b), pool_size)
        np.testing.assert_allclose(c.numpy(), np.asarray(d), rtol=1e-5, atol=1e-6)
    assert estimation.pool_config(cfg, 1 << 12).m == 1 << 12
    with pytest.raises(ValueError, match="exceed"):
        estimation.pool_config(cfg, 64)
    # The chunked solve gives the unchunked answer.
    big = torch.from_numpy(np.tile(hists, (3, 1)))
    saved = estimation._VIRTUAL_CHUNK_BYTES
    try:
        estimation._VIRTUAL_CHUNK_BYTES = 128 * cfg.num_bins * 4 * 5  # 5 rows per chunk
        chunked = estimation.estimate_hists_virtual(cfg, big)
    finally:
        estimation._VIRTUAL_CHUNK_BYTES = saved
    # torch's CPU reductions may sum in another order at another batch size.
    torch.testing.assert_close(chunked, estimation.estimate_hists_virtual(cfg, big), rtol=1e-6, atol=0)


@pytest.mark.parametrize("m_virtual", [None, 96])
def test_estimate_tenants_matches_jax(m_virtual):
    rng = np.random.default_rng(9)
    tids = rng.integers(0, 1 << 63, 48, dtype=np.uint64)
    cfg_j, vj, cfg, vt = _configs(m_virtual, m=64, b=8, pool_size=1 << 13, pinned=tids[:3])
    sj, st = jv.init(cfg_j, vj), vda.init(cfg, vt, device="cpu")
    for i in range(3):
        tk, ids, w, _ = _stream(1500, tids, seed=20 + i)
        sj = jv.update_tenants(cfg_j, vj, sj, _jpair(tk), _jpair(ids), jnp.asarray(w))
        st = vda.update_tenants(cfg, vt, st, _tpair(tk), _tpair(ids), torch.from_numpy(w))
    ghosts = rng.integers(0, 1 << 63, 8, dtype=np.uint64)
    query = np.concatenate([tids, ghosts])
    got = vda.estimate_tenants(cfg, vt, st, _tpair(query)).numpy()
    want = np.asarray(jv.estimate_tenants(cfg_j, vj, sj, _jpair(query)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[:3], st.hot.chats.numpy())
    np.testing.assert_allclose(float(vda.pool_calibration(cfg, vt, st)),
                               float(jv.pool_calibration(cfg_j, vj, sj)), rtol=1e-5)
    np.testing.assert_allclose(float(vda.estimate_pool_total(cfg, vt, st)),
                               float(jv.estimate_pool_total(cfg_j, vj, sj)), rtol=1e-5)
    rows = vda.virtual_rows(cfg, vt, st, *_tpair(tids)).numpy()
    np.testing.assert_array_equal(rows, np.asarray(jv.virtual_rows(cfg_j, vj, sj, *_jpair(tids))))


def test_route_slots_vectorized_pinned_lookup_matches_jax():
    """P = 64 pinned tenants (ids above 2^63 among them) through one sorted
    table: the same slots as the JAX package's per-tenant chain."""
    rng = np.random.default_rng(11)
    pinned = rng.integers(0, 2**64, 64, dtype=np.uint64)
    pinned[:3] = [0, 2**64 - 1, 2**63]
    others = rng.integers(0, 2**64, 500, dtype=np.uint64)
    keys = np.concatenate([pinned, others, pinned[::-1]])
    rng.shuffle(keys)
    dj = jkd.DirectoryConfig(capacity=1000, seed=5, pinned=tuple(int(t) for t in pinned))
    dt = key_directory.DirectoryConfig(capacity=1000, seed=5, pinned=tuple(int(t) for t in pinned))
    want = np.asarray(jkd.route_slots(dj, _jpair(keys)))
    got = key_directory.route_slots(dt, _tpair(keys)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < 64).sum() == 128
    # A 64-bit int64 tensor carries the same ids (two's complement above 2^63).
    np.testing.assert_array_equal(
        key_directory.route_slots(dt, torch.from_numpy(keys.view(np.int64))).numpy(), want)


def test_mask_and_degenerate_weights_drop_rows():
    rng = np.random.default_rng(12)
    tids = rng.integers(0, 1 << 63, 10, dtype=np.uint64)
    _, _, cfg, vt = _configs(pinned=tids[:2])
    tk, ids, w, _ = _stream(200, tids, seed=1)
    st = vda.init(cfg, vt, device="cpu")
    bad = w.copy()
    bad[:100] = np.nan
    mask = np.ones(200, bool)
    mask[100:] = False
    out = vda.update_tenants(cfg, vt, st, _tpair(tk), _tpair(ids), torch.from_numpy(bad), torch.from_numpy(mask))
    assert int(out.n_tail) == 0 and float(out.w_tail) == 0.0
    assert (out.pool == cfg.r_min).all() and (out.hot.regs == cfg.r_min).all()
    assert int(out.pool_hist[0]) == vt.pool_size


def test_config_guards_and_memory_accounting():
    cfg = SketchConfig(m=128, b=8, seed=0)
    vt = VirtualConfig(pool_size=1 << 16, pinned=(1, 2))
    st = vda.init(cfg, vt, device="cpu")
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    assert vda.memory_bytes(cfg, vt) == (
        nbytes(st.pool) + nbytes(st.pool_hist) + 4 + 4
        + nbytes(st.hot.regs) + nbytes(st.hot.hists) + nbytes(st.hot.chats)
    )
    jc = JCfg(m=128, b=8, seed=0)
    assert vda.memory_bytes(cfg, vt) == jv.memory_bytes(jc, JVCfg(pool_size=1 << 16, pinned=(1, 2)))
    assert vda.dense_memory_bytes(cfg, 10**7) == jv.dense_memory_bytes(jc, 10**7)
    assert vda.dense_memory_bytes(cfg, 10**7) / vda.memory_bytes(cfg, vt) > 10
    assert vt.salt_pool == JVCfg(pool_size=1 << 16).salt_pool
    assert vda.tail_config(cfg, dataclasses.replace(vt, m_virtual=96)).m == 96
    for bad in (dict(pool_size=2), dict(pool_size=64, m_virtual=1), dict(pool_size=64, pinned=(3, 3)),
                dict(pool_size=64, pinned=(2**64,))):
        with pytest.raises(ValueError):
            VirtualConfig(**bad)
    with pytest.raises(ValueError, match="exceed"):
        vda.init(cfg, VirtualConfig(pool_size=100), device="cpu")


def test_convert_round_trips_new_state_types(jax_registry_off):
    rng = np.random.default_rng(13)
    tids = rng.integers(0, 1 << 63, 12, dtype=np.uint64)
    cfg_j, vj, cfg, vt = _configs(pinned=tids[:2])
    jm = jmon.VirtualDynMonitor(cfg_j, vj)
    tk, ids, w, _ = _stream(300, tids, seed=2)
    sj = jm.update(jm.init(), _jpair(tk), _jpair(ids), jnp.asarray(w))
    def to_np(state):
        return type(state)(*(to_np(x) if isinstance(x, tuple) else np.asarray(x) for x in state))

    def leaves(state):
        return [y for x in state for y in (leaves(x) if isinstance(x, tuple) else [x])]

    for state in (sj, sj.array):
        as_np = to_np(state)
        back = convert.to_numpy(convert.from_jax_numpy(as_np, device="cpu"))
        assert type(back).__name__ == type(state).__name__
        assert len(leaves(back)) == len(leaves(as_np)) == len(leaves(state))
        for a, b in zip(leaves(back), leaves(as_np)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # The converted state carries on like the JAX one.
    st = convert.from_jax_numpy(to_np(sj.array), device="cpu")
    assert isinstance(st, VirtualDynArrayState) and st.pool.dtype == torch.int8
    tk2, ids2, w2, _ = _stream(200, tids, seed=3)
    sj2 = jv.update_tenants(cfg_j, vj, sj.array, _jpair(tk2), _jpair(ids2), jnp.asarray(w2))
    st2 = vda.update_tenants(cfg, vt, st, _tpair(tk2), _tpair(ids2), torch.from_numpy(w2))
    _assert_state(st2, sj2)


def test_monitor_surface_matches_jax(jax_registry_off):
    rng = np.random.default_rng(14)
    tids = rng.integers(0, 1 << 63, 20, dtype=np.uint64)
    cfg_j, cfg = JCfg(m=64, b=8, seed=4), SketchConfig(m=64, b=8, seed=4)
    pinned = tuple(int(t) for t in tids[:3])
    jm = jmon.VirtualDynMonitor.for_pool(cfg_j, 1 << 12, pinned=pinned)
    mon = monitor.VirtualDynMonitor.for_pool(cfg, 1 << 12, pinned=pinned, device="cpu")
    assert mon.vcfg.seed == jm.vcfg.seed == cfg.seed and mon.vcfg.salt_pool == jm.vcfg.salt_pool
    sj, st = [], []
    for seed in (5, 6):
        tk, ids, w, mask = _stream(400, tids, seed=seed)
        sj.append(jm.update(jm.init(), _jpair(tk), _jpair(ids), jnp.asarray(w), jnp.asarray(mask)))
        st.append(mon.update(mon.init(), _tpair(tk), _tpair(ids), torch.from_numpy(w), torch.from_numpy(mask)))
        assert int(st[-1].n_seen) == int(mask.sum()) == int(sj[-1].n_seen)
        _assert_state(st[-1].array, sj[-1].array)
    mj, mt = jm.merge(*sj), mon.merge(*st)
    _assert_state(mt.array, mj.array)
    assert int(mt.n_seen) == int(mj.n_seen)
    np.testing.assert_allclose(mon.estimate(mt, _tpair(tids)).numpy(),
                               np.asarray(jm.estimate(mj, _jpair(tids))), rtol=1e-5, atol=1e-6)
    got, want = mon.metrics(mt), jm.metrics(mj)
    assert list(got) == list(want)
    for k in got:  # the chats' tolerance (the merged hot rows re-estimate to about 0)
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    mon2, st2 = mon.promote(mt, int(tids[5]), migrate=True)
    jm2, sj2 = jm.promote(mj, int(tids[5]), migrate=True)
    assert mon2.vcfg.pinned == jm2.vcfg.pinned and mon2.device == mon.device
    _assert_state(st2.array, sj2.array)


def _load_example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_virtual_tenants_scenario_matches_jax(jax_registry_off):
    """``examples/virtual_tenants.py``: 2048 Zipf tenants (32 pinned) into a
    2^16-slot pool at m = 128 in batches of 8192; the reads against exact
    truth; the promotion of rank 32 (epoch fence) and 4096 fresh events."""
    cfg_j, cfg = JCfg(m=128, b=8, seed=3), SketchConfig(m=128, b=8, seed=3)
    n_tenants, n_pin, pool_size = 2048, 32, 2**16
    rng = np.random.default_rng(7)
    tenant_ids = rng.integers(0, 2**63, n_tenants, dtype=np.uint64)
    sizes = np.maximum(6000.0 / np.arange(1, n_tenants + 1) ** 1.05, 8).astype(int)
    pinned = tuple(int(t) for t in tenant_ids[:n_pin])
    jm = jmon.VirtualDynMonitor.for_pool(cfg_j, pool_size, pinned=pinned)
    mon = monitor.VirtualDynMonitor.for_pool(cfg, pool_size, pinned=pinned, device="cpu")
    sj, st = jm.init(), mon.init()
    tidx = np.repeat(np.arange(n_tenants), sizes)
    rng.shuffle(tidx)
    n = tidx.shape[0]
    ids = rng.permutation(np.arange(n, dtype=np.uint32))
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    truth = np.zeros(n_tenants)
    np.add.at(truth, tidx, w)
    for lo in range(0, n, 8192):
        sl = slice(lo, min(lo + 8192, n))
        sj = jm.update(sj, _jpair(tenant_ids[tidx[sl]]), jnp.asarray(ids[sl]), jnp.asarray(w[sl]))
        st = mon.update(st, _tpair(tenant_ids[tidx[sl]]), torch.from_numpy(ids[sl].astype(np.int64)),
                        torch.from_numpy(w[sl]))
    _assert_state(st.array, sj.array)
    floor = float(vda.noise_floor(cfg, mon.vcfg, st.array))
    est = mon.estimate(st, _tpair(tenant_ids)).numpy()
    est_j = np.asarray(jm.estimate(sj, _jpair(tenant_ids)))
    np.testing.assert_allclose(est[:n_pin], est_j[:n_pin], rtol=1e-5, atol=1e-6)
    # The tail reads, stage by stage: the row solves on the same gathered
    # registers, then the calibration. One row's grid argmax flips between
    # torch and XLA: rank 1286, at an exact float32 tie of two points of the
    # JAX package's last grid stage (ROADMAP queue 3, with its histogram).
    rows = vda.virtual_rows(cfg, mon.vcfg, st.array, *_tpair(tenant_ids))
    rows_j = jv.virtual_rows(cfg_j, jm.vcfg, sj.array, *_jpair(tenant_ids))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_j))
    chat_v = estimation.estimate_rows_virtual(cfg, rows).numpy()
    chat_vj = np.asarray(jest.estimate_rows_virtual(cfg_j, rows_j))
    off = np.abs(chat_v - chat_vj) > 1e-5 * np.abs(chat_vj)
    assert set(np.flatnonzero(off)) == {1286}
    np.testing.assert_allclose(float(vda.pool_calibration(cfg, mon.vcfg, st.array)),
                               float(jv.pool_calibration(cfg_j, jm.vcfg, sj.array)), rtol=1e-5)
    rel = np.abs(est - truth) / truth
    tail_above = (truth >= 2 * floor) & (np.arange(n_tenants) >= n_pin)
    assert rel[:n_pin].mean() < 0.1 and tail_above.sum() > 0 and rel[tail_above].mean() < 0.5
    assert float(mon.metrics(st)["virtual_pool_load_factor"]) < 0.5

    riser = int(tenant_ids[n_pin])
    mon, st = mon.promote(st, riser)
    jm, sj = jm.promote(sj, riser)
    w2 = rng.uniform(0.5, 1.5, 4096).astype(np.float32)
    fresh = np.arange(n, n + 4096, dtype=np.uint32)
    st = mon.update(st, _tpair(np.full(4096, riser, np.uint64)), torch.from_numpy(fresh.astype(np.int64)),
                    torch.from_numpy(w2))
    sj = jm.update(sj, _jpair(np.full(4096, riser, np.uint64)), jnp.asarray(fresh), jnp.asarray(w2))
    _assert_state(st.array, sj.array)
    resumed = float(mon.estimate(st, _tpair([riser]))[0])
    assert abs(resumed - w2.sum()) / w2.sum() < 0.2
    assert vda.memory_bytes(cfg, mon.vcfg) == jv.memory_bytes(cfg_j, jm.vcfg)
