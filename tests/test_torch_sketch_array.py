"""The port's per-key SketchArray (kernel K6's path) against the JAX package
on the CPU.

Same inputs, made from a seed with numpy, through both packages. Registers
bit for bit (against the JAX core update, the JAX ops front and the JAX
Pallas entry run with ``interpret=True``); MLE reads to rtol 1e-5 against
the JAX newton solve (``tests/test_torch_slice.py``'s tolerance) and within
LUT_RTOL / ATOL_FLOOR of the float64 oracle. Weights are >= 0 throughout:
a negative or NaN weight meets the reference fault logged in ROADMAP
queue 3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SketchConfig as JCfg
from repro.core import estimators as jest
from repro.core import key_directory as jkd
from repro.core import sketch_array as jsa
from repro.data import synthetic as jsynth
from repro.kernels import ops as jops
from repro.kernels import sketch_array_update as jk6
from repro.obs import metrics as jmetrics
from repro.sketchstream import monitor as jmon
from repro_torch import convert
from repro_torch.core import SketchConfig, estimation, key_directory, sketch_array
from repro_torch.core.types import SketchArrayState
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref
from repro_torch.sketchstream import monitor

# (batch, m, K) — ragged on purpose, as in the JAX package's suite.
SHAPES = [(300, 64, 33), (100, 130, 7), (513, 96, 16)]


@pytest.fixture
def jax_registry_off():
    """The JAX ops fronts and monitors reach ``jax.core.trace_state_clean``
    (gone in this jax) only while the JAX registry is on: switch it off for
    the test and restore the process-wide state afterwards."""
    was = jmetrics.enabled()
    jmetrics.configure(enabled=False)
    yield
    jmetrics.configure(enabled=was)


def _keyed(batch, k, seed, *, n_ids=None, key_lo=0, key_hi=None):
    """Keyed batch with in-batch duplicates, zero weights and a mask."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, n_ids or batch, dtype=np.uint32)
    ids = pool[rng.integers(0, len(pool), batch)]
    w = (rng.gamma(1.0, 2.0, batch) + 1e-4).astype(np.float32)
    w[rng.random(batch) < 0.05] = 0.0
    mask = rng.random(batch) > 0.1
    keys = rng.integers(key_lo, k if key_hi is None else key_hi, batch).astype(np.int32)
    return keys, ids, w, mask


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _ids_t(ids):
    return torch.from_numpy(np.asarray(ids).astype(np.int64))


@pytest.mark.parametrize("batch,m,k", SHAPES)
@pytest.mark.parametrize("variant", ["dense", "clipped", "masked"])
def test_update_matches_jax_core_and_ops_front(batch, m, k, variant, jax_registry_off):
    cfg_j, cfg = JCfg(m=m, b=8, seed=m + k), SketchConfig(m=m, b=8, seed=m + k)
    sj, sk = jsa.init(cfg_j, k), jsa.init(cfg_j, k)
    st = sketch_array.init(cfg, k, device="cpu")
    for i in range(3):
        if variant == "clipped":  # keys below 0 and at or above K clip to the edge rows
            keys, ids, w, mask = _keyed(batch, k, seed=10 * i + k, key_lo=-3, key_hi=k + 4)
        else:
            keys, ids, w, mask = _keyed(batch, k, seed=10 * i + k)
        mj = jnp.asarray(mask) if variant == "masked" else None
        mt = _t(mask) if variant == "masked" else None
        args_j = (jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w))
        sj = jsa.update(cfg_j, sj, *args_j, mask=mj)
        sk = jops.sketch_array_update_op(cfg_j, sk, *args_j, mask=mj, interpret=True)
        out = sketch_array.update(cfg, st, _t(keys), _ids_t(ids), _t(w), mask=mt)
        assert out.regs is st.regs  # updated in place
        np.testing.assert_array_equal(st.regs.numpy(), np.asarray(sj.regs))
        np.testing.assert_array_equal(st.regs.numpy(), np.asarray(sk.regs))
    assert (st.regs.numpy() > cfg.r_min).any()
    if variant == "clipped":
        touched = (st.regs.numpy() > cfg.r_min).any(1)
        assert touched[0] and touched[k - 1]


@pytest.mark.parametrize("batch,m,k", SHAPES)
def test_k6_plain_matches_jax_padded_kernel(batch, m, k):
    cfg = SketchConfig(m=m, b=8, seed=batch)
    rng = np.random.default_rng(batch + m)
    lo = rng.integers(0, 2**32, batch, dtype=np.uint32)
    hi = rng.integers(0, 2**32, batch, dtype=np.uint32)
    w = (rng.gamma(1.0, 2.0, batch) + 1e-5).astype(np.float32)
    w[::7] = 0.0  # zero weights: log2 w = -inf, a no-op row
    with np.errstate(divide="ignore"):
        log2w = np.log2(w).astype(np.float32)
    keys = rng.integers(0, k, batch).astype(np.int64)
    regs = rng.integers(cfg.r_min, 3, (k, m)).astype(np.int8)

    bb, bm = 64, 128
    bp, mp, kp = -(-batch // bb) * bb, -(-m // bm) * bm, -(-k // 8) * 8
    pad = lambda a, n, fill: np.concatenate([a, np.full(n - len(a), fill, a.dtype)])[:, None]  # noqa: E731
    regs_p = np.full((kp, mp), cfg.r_min, np.int32)
    regs_p[:k, :m] = regs
    out_j = jk6.sketch_array_update_padded(
        jnp.asarray(pad(lo, bp, 0)), jnp.asarray(pad(hi, bp, 0)),
        jnp.asarray(pad(log2w, bp, -np.inf)), jnp.asarray(pad(keys.astype(np.int32), bp, 0)),
        jnp.asarray(regs_p), block_b=bb, block_m=bm, salt=cfg.salt_h, r_min=cfg.r_min,
        r_max=cfg.r_max, interpret=True,
    )
    out_t = ref.sketch_array_update_ref(
        _t(lo.astype(np.int64)), _t(hi.astype(np.int64)), _t(log2w), _t(keys), _t(regs),
        salt=cfg.salt_h, r_min=cfg.r_min, r_max=cfg.r_max,
    )
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j)[:k, :m].astype(np.int8))
    # The front updates in place and equals the plain version.
    regs_t = _t(regs.copy())
    got = ops.sketch_array_update_op(
        cfg, regs_t, _t(keys), _t(lo.astype(np.int64)), _t(hi.astype(np.int64)), _t(log2w)
    )
    assert got is regs_t
    np.testing.assert_array_equal(regs_t.numpy(), out_t.numpy())


def test_k6_front_checks_operands():
    cfg = SketchConfig(m=64, b=8)
    regs = sketch_array.init(cfg, 4, device="cpu").regs
    lo = hi = torch.zeros(5, dtype=torch.int64)
    lw = torch.zeros(5)
    keys = torch.zeros(5, dtype=torch.int64)
    with pytest.raises(TypeError, match="dtype"):
        ops.sketch_array_update_op(cfg, regs, keys.to(torch.int32), lo, hi, lw)
    with pytest.raises(ValueError, match="shape"):
        ops.sketch_array_update_op(cfg, regs, keys[:4], lo, hi, lw)
    with pytest.raises(ValueError, match="shape"):
        ops.sketch_array_update_op(cfg, regs[:, :32].contiguous(), keys, lo, hi, lw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sketch_array_update_op(cfg, torch.full((64, 4), cfg.r_min, dtype=torch.int8).t(), keys, lo, hi, lw)


def _dense_array(cfg_j, cfg, k, dense_keys, seed):
    """A SketchArray on both sides: light traffic on every row, then ~3000
    distinct elements on each of ``dense_keys``."""
    sj, st = jsa.init(cfg_j, k), sketch_array.init(cfg, k, device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(2):
        keys, ids, w, mask = _keyed(400, k, seed=int(rng.integers(1 << 30)))
        sj = jsa.update(cfg_j, sj, jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
        st = sketch_array.update(cfg, st, _t(keys), _ids_t(ids), _t(w), mask=_t(mask))
    n = 3000 * len(dense_keys)
    keys = np.asarray(dense_keys, np.int32)[rng.integers(0, len(dense_keys), n)]
    ids = rng.integers(0, 2**32, n, dtype=np.uint32)
    w = (rng.gamma(1.0, 2.0, n) + 1e-4).astype(np.float32)
    sj = jsa.update(cfg_j, sj, jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w))
    st = sketch_array.update(cfg, st, _t(keys), _ids_t(ids), _t(w))
    np.testing.assert_array_equal(st.regs.numpy(), np.asarray(sj.regs))
    return sj, st


def test_estimate_all_with_ci_on_dense_rows_matches_jax():
    k, m = 12, 64
    cfg_j, cfg = JCfg(m=m, b=8, seed=3), SketchConfig(m=m, b=8, seed=3)
    sj, st = _dense_array(cfg_j, cfg, k, dense_keys=(0, 5, 9), seed=1)
    chat, std, ok = sketch_array.estimate_all_with_ci(cfg, st)
    chat_j, std_j, ok_j = jsa.estimate_all_with_ci(cfg_j, sj)
    assert (chat.numpy()[[0, 5, 9]] > 1000).all()
    np.testing.assert_allclose(chat.numpy(), np.asarray(chat_j), rtol=1e-5, atol=estimation.ATOL_FLOOR)
    np.testing.assert_allclose(std.numpy(), np.asarray(std_j), rtol=1e-5, atol=estimation.ATOL_FLOOR)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(sketch_array.estimate_all(cfg, st).numpy(), chat.numpy())
    np.testing.assert_array_equal(
        sketch_array.histograms(cfg, st).numpy(), np.asarray(jsa.histograms(cfg_j, sj))
    )
    for r in (0, 5, 9):
        oracle = jest.mle_numpy(cfg_j, np.asarray(sj.regs[r]))
        assert abs(float(chat[r]) - oracle) <= estimation.LUT_RTOL * oracle + estimation.ATOL_FLOOR


def test_merge_row_and_update_reference_match_jax():
    k, m = 9, 64
    cfg_j, cfg = JCfg(m=m, b=8, seed=4), SketchConfig(m=m, b=8, seed=4)
    sa_j, sa = _dense_array(cfg_j, cfg, k, dense_keys=(1,), seed=2)
    sb_j, sb = _dense_array(cfg_j, cfg, k, dense_keys=(1, 2), seed=3)
    mj, mt = jsa.merge(sa_j, sb_j), sketch_array.merge(sa, sb)
    np.testing.assert_array_equal(mt.regs.numpy(), np.asarray(mj.regs))
    with pytest.raises(ValueError, match="matching"):
        sketch_array.merge(sa, sketch_array.init(cfg, k + 1, device="cpu"))
    assert sketch_array.num_sketches(sa) == k == jsa.num_sketches(sa_j)
    np.testing.assert_array_equal(sketch_array.row(sa, 2).regs.numpy(), np.asarray(jsa.row(sa_j, 2).regs))
    with pytest.raises(IndexError):
        sketch_array.row(sa, k)
    # The K-loop oracle of both packages, from a non-empty state, with a mask.
    keys, ids, w, mask = _keyed(300, k, seed=7)
    before = sa.regs.clone()
    oj = jsa.update_reference(cfg_j, sa_j, jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
    ot = sketch_array.update_reference(cfg, sa, _t(keys), _ids_t(ids), _t(w), mask=_t(mask))
    np.testing.assert_array_equal(ot.regs.numpy(), np.asarray(oj.regs))
    np.testing.assert_array_equal(sa.regs.numpy(), before.numpy())  # the oracle copies
    fused = sketch_array.update(cfg, sa, _t(keys), _ids_t(ids), _t(w), mask=_t(mask))
    np.testing.assert_array_equal(fused.regs.numpy(), ot.regs.numpy())


def _tenants(n, seed):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64, 40, dtype=np.uint64)
    pool[0] = 2**64 - 1
    return pool[rng.integers(0, len(pool), n)], pool


def test_update_tenants_and_directory_match_jax():
    k = 32
    cfg_j, cfg = JCfg(m=64, b=8, seed=9), SketchConfig(m=64, b=8, seed=9)
    _, pool = _tenants(1, seed=0)
    pinned = (int(pool[3]),)
    dcfg_j = jkd.DirectoryConfig(capacity=k, seed=3, pinned=pinned)
    dcfg = key_directory.DirectoryConfig(capacity=k, seed=3, pinned=pinned)
    sj, dj = jsa.init(cfg_j, k), jkd.init(dcfg_j)
    st, dt = sketch_array.init(cfg, k, device="cpu"), key_directory.init(dcfg, "cpu")
    for i in range(3):
        _, ids, w, mask = _keyed(300, k, seed=20 + i, n_ids=200)
        tenants, _ = _tenants(300, seed=10 + i)
        kj, kt = jkd.split_uint64(tenants), key_directory.split_uint64(tenants, device="cpu")
        sj, dj = jsa.update_tenants(cfg_j, dcfg_j, sj, dj, kj, jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
        st, dt = sketch_array.update_tenants(cfg, dcfg, st, dt, kt, _ids_t(ids), _t(w), mask=_t(mask))
        np.testing.assert_array_equal(st.regs.numpy(), np.asarray(sj.regs))
        port_dir = convert.to_numpy(dt)
        for name in jkd.DirectoryState._fields:
            np.testing.assert_array_equal(getattr(port_dir, name), np.asarray(getattr(dj, name)))
    assert int(dt.n_collisions) > 0
    with pytest.raises(ValueError, match="capacity"):
        sketch_array.update_tenants(cfg, dcfg, sketch_array.init(cfg, k + 1, device="cpu"), dt, kt,
                                    _ids_t(ids), _t(w))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense_slots", "dcfg"])
def test_array_monitor_matches_jax(sparse):
    k = 24
    cfg_j, cfg = JCfg(m=64, b=8, seed=5), SketchConfig(m=64, b=8, seed=5)
    dcfg_j = jkd.DirectoryConfig(capacity=k, seed=8) if sparse else None
    dcfg = key_directory.DirectoryConfig(capacity=k, seed=8) if sparse else None
    sj, st = jmon.init_array(cfg_j, k), monitor.init_array(cfg, k, device="cpu")
    for i in range(3):
        keys, ids, w, mask = _keyed(240, k, seed=30 + i, n_ids=150)
        shape = (24, 10)  # a (batch, experts)-shaped routing tensor, flattened by both
        ids2, w2, m2 = ids.reshape(shape), w.reshape(shape), mask.reshape(shape)
        if sparse:
            tenants, _ = _tenants(240, seed=40 + i)
            kj = jkd.split_uint64(tenants)
            kj = (kj[0].reshape(shape), kj[1].reshape(shape))
            kt = key_directory.split_uint64(tenants, device="cpu")
            kt = (kt[0].reshape(shape), kt[1].reshape(shape))
        else:
            kj, kt = jnp.asarray(keys.reshape(shape)), _t(keys.reshape(shape))
        sj = jmon.update_array(cfg_j, sj, kj, jnp.asarray(ids2), jnp.asarray(w2), mask=jnp.asarray(m2), dcfg=dcfg_j)
        st = monitor.update_array(cfg, st, kt, _ids_t(ids2), _t(w2), mask=_t(m2), dcfg=dcfg)
        np.testing.assert_array_equal(st.regs.numpy(), np.asarray(sj.regs))
        assert int(st.n_seen) == int(sj.n_seen)
    np.testing.assert_allclose(
        monitor.estimate_array(cfg, st).numpy(), np.asarray(jmon.estimate_array(cfg_j, sj)),
        rtol=1e-5, atol=estimation.ATOL_FLOOR,
    )
    # Unweighted update (weight 1.0 when not given), then a merge.
    ids = np.arange(100, dtype=np.uint32)
    keys = (np.arange(100) % k).astype(np.int32)
    if sparse:
        kj, kt = jnp.asarray(keys.astype(np.uint32)), _t(keys.astype(np.int64))
    else:
        kj, kt = jnp.asarray(keys), _t(keys)
    oj = jmon.update_array(cfg_j, jmon.init_array(cfg_j, k), kj, jnp.asarray(ids), dcfg=dcfg_j)
    ot = monitor.update_array(cfg, monitor.init_array(cfg, k, device="cpu"), kt, _ids_t(ids), dcfg=dcfg)
    np.testing.assert_array_equal(ot.regs.numpy(), np.asarray(oj.regs))
    mj, mt = jmon.merge_array(cfg_j, sj, oj), monitor.merge_array(cfg, st, ot)
    np.testing.assert_array_equal(mt.regs.numpy(), np.asarray(mj.regs))
    assert int(mt.n_seen) == int(mj.n_seen)


def test_convert_round_trip_carries_on_like_jax():
    k = 10
    cfg_j, cfg = JCfg(m=64, b=8, seed=6), SketchConfig(m=64, b=8, seed=6)
    keys, ids, w, mask = _keyed(200, k, seed=50)
    sj = jsa.update(cfg_j, jsa.init(cfg_j, k), jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w))
    st = convert.from_jax_numpy(sj, device="cpu")
    assert type(st) is SketchArrayState
    keys, ids, w, mask = _keyed(200, k, seed=51)
    sj = jsa.update(cfg_j, sj, jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w), mask=jnp.asarray(mask))
    st = sketch_array.update(cfg, st, _t(keys), _ids_t(ids), _t(w), mask=_t(mask))
    back = convert.to_numpy(st)
    np.testing.assert_array_equal(back.regs, np.asarray(sj.regs))
    assert back.regs.dtype == np.int8
    aj = jmon.update_array(cfg_j, jmon.init_array(cfg_j, k), jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(w))
    at = convert.from_jax_numpy(aj, device="cpu")
    assert type(at) is monitor.ArrayMonitorState and at.n_seen.dtype == torch.int32
    for a, b in zip(convert.to_numpy(at), aj):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_synthetic_netflow_streams_match_jax():
    for got, want in zip(synthetic.netflow(500, 3000, seed=4), jsynth.netflow(500, 3000, seed=4)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    got = synthetic.netflow_keyed(16, 800, 5000, seed=3)
    want = jsynth.netflow_keyed(16, 800, 5000, seed=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype

