"""The port's baselines (LM, FastGM, FastExpSketch; kernel K5's path) and the
``METHODS`` registry against the JAX package on the CPU.

Same inputs, made from a seed with numpy, through both packages.
Tolerances (ROADMAP's parity contract): LM registers rtol 1e-6 (torch-CPU
and XLA round -ln u differently by an ulp on some words); FastGM and
FastExpSketch registers rtol 1e-5 (their cumsum sums in another order);
``lm_estimate`` rtol 1e-5; FastGM's ``_positions``, QSketch registers and
the synthetic streams bit for bit. Weights are > 0 wherever LM meets the
JAX package: on a weight <= 0 or NaN the JAX ``lm_update`` writes a negative
or NaN r, while the port follows K5 (a no-op row; ROADMAP queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import METHODS as JMETHODS
from repro.core import SketchConfig as JCfg
from repro.core import baselines as jb
from repro.core import qsketch as jq
from repro.data import synthetic as jsynth
from repro.kernels import qsketch_update as jk
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import METHODS, SketchConfig, baselines, estimators, qsketch
from repro_torch.core.types import FloatSketchState
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref

METHOD_NAMES = ("LM", "FastGM", "FastExpSketch", "QSketch", "QSketch-Dyn")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _ids_t(ids):
    return torch.from_numpy(np.asarray(ids).astype(np.int64))


def _batch(n, seed, *, n_ids=None):
    """Element ids (32-bit, with duplicates) and positive gamma weights."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, n_ids or n, dtype=np.uint32)
    ids = pool[rng.integers(0, len(pool), n)]
    w = (rng.gamma(1.0, 2.0, n) + 1e-4).astype(np.float32)
    mask = rng.random(n) > 0.2
    return ids, w, mask


@pytest.mark.parametrize("batch,m", [(300, 64), (100, 130), (513, 256)])
def test_k5_plain_matches_jax_padded_kernel(batch, m):
    cfg = SketchConfig(m=m, b=8, seed=batch + m)
    rng = np.random.default_rng(m)
    lo = rng.integers(0, 2**32, batch, dtype=np.uint32)
    hi = rng.integers(0, 2**32, batch, dtype=np.uint32)
    w = (rng.gamma(1.0, 2.0, batch) + 1e-5).astype(np.float32)
    w[::7] = 0.0  # non-positive weights are no-op rows in both
    w[3::11] = -1.0
    regs = np.where(rng.random(m) < 0.5, np.float32(np.finfo(np.float32).max),
                    rng.exponential(0.5, m).astype(np.float32)).astype(np.float32)

    bb, bm = 64, 128
    bp, mp = -(-batch // bb) * bb, -(-m // bm) * bm
    pad = lambda a, n, fill: np.concatenate([a, np.full(n - len(a), fill, a.dtype)])[:, None]  # noqa: E731
    regs_p = np.full((1, mp), np.inf, np.float32)
    regs_p[0, :m] = regs
    args_j = (jnp.asarray(pad(lo, bp, 0)), jnp.asarray(pad(hi, bp, 0)), jnp.asarray(pad(w, bp, -1.0)),
              jnp.asarray(regs_p))
    out_j = np.asarray(jk.float_sketch_update_padded(*args_j, block_b=bb, block_m=bm, salt=cfg.salt_h,
                                                     interpret=True))[0, :m]
    out_r = np.asarray(jref.float_sketch_update_ref(*args_j, salt=cfg.salt_h))[0, :m]
    args_t = (_t(lo.astype(np.int64)), _t(hi.astype(np.int64)), _t(w))
    out_t = ref.float_sketch_update_ref(*args_t, _t(regs), salt=cfg.salt_h).numpy()
    assert (out_t < regs).any()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=0)
    np.testing.assert_allclose(out_t, out_r, rtol=1e-6, atol=0)
    # The front on a CPU tensor is the plain version.
    got = ops.float_sketch_update_op(cfg, _t(regs), *args_t)
    np.testing.assert_array_equal(got.numpy(), out_t)


def test_k5_front_checks_operands():
    cfg = SketchConfig(m=64, b=8)
    regs = baselines.init(cfg, device="cpu").regs
    lo = hi = torch.zeros(5, dtype=torch.int64)
    w = torch.ones(5)
    with pytest.raises(TypeError, match="dtype"):
        ops.float_sketch_update_op(cfg, regs.double(), lo, hi, w)
    with pytest.raises(ValueError, match="shape"):
        ops.float_sketch_update_op(cfg, regs, lo, hi, w[:4])
    with pytest.raises(TypeError, match="dtype"):
        ops.float_sketch_update_op(cfg, regs, lo.int(), hi, w)


@pytest.mark.parametrize("m", [64, 130])
@pytest.mark.parametrize("masked", [False, True])
def test_lm_update_matches_jax(m, masked):
    cfg_j, cfg = JCfg(m=m, b=8, seed=m), SketchConfig(m=m, b=8, seed=m)
    sj, st = jb.init(cfg_j), baselines.init(cfg, device="cpu")
    for i in range(3):
        ids, w, mask = _batch(400, seed=10 * i + m, n_ids=300)
        sj = jb.lm_update(cfg_j, sj, jnp.asarray(ids), jnp.asarray(w), jnp.asarray(mask) if masked else None)
        st = baselines.lm_update(cfg, st, _t(ids), _t(w), _t(mask) if masked else None)
        np.testing.assert_allclose(st.regs.numpy(), np.asarray(sj.regs), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(baselines.estimate(st)), float(jb.estimate(sj)), rtol=1e-5)


@pytest.mark.parametrize("method", ["FastGM", "FastExpSketch"])
@pytest.mark.parametrize("masked", [False, True])
def test_fast_updates_match_jax(method, masked):
    m = 64
    cfg_j, cfg = JCfg(m=m, b=8, seed=7), SketchConfig(m=m, b=8, seed=7)
    upd_j, upd = JMETHODS[method]["update"], METHODS[method]["update"]
    sj, st = jb.init(cfg_j), baselines.init(cfg, device="cpu")
    for i in range(4):  # later batches meet the prune against a filled sketch
        ids, w, mask = _batch(500, seed=i + 3 * masked)
        sj = upd_j(cfg_j, sj, jnp.asarray(ids), jnp.asarray(w), jnp.asarray(mask) if masked else None)
        st = upd(cfg, st, _t(ids), _t(w), _t(mask) if masked else None)
        np.testing.assert_allclose(st.regs.numpy(), np.asarray(sj.regs), rtol=1e-5, atol=0)
        keep_j = np.asarray(jb.fastgm_prune_mask(cfg_j, sj, jnp.asarray(ids), jnp.asarray(w)))
        keep = baselines.fastgm_prune_mask(cfg, st, _t(ids), _t(w)).numpy()
        np.testing.assert_array_equal(keep, keep_j)
    assert not keep.all()  # the prune drops elements once the sketch fills
    np.testing.assert_allclose(float(baselines.estimate(st)), float(jb.estimate(sj)), rtol=1e-5)


def test_fastgm_internals_match_jax():
    """_positions bit for bit over a 50k-element batch (32-bit hash ties
    within one element's m keys occur at this size, so a stable argsort is
    needed); _os_values to rtol 1e-5."""
    m, n = 64, 50_000
    cfg_j, cfg = JCfg(m=m, b=8, seed=1), SketchConfig(m=m, b=8, seed=1)
    rng = np.random.default_rng(5)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    w = (rng.gamma(1.0, 2.0, n) + 1e-4).astype(np.float32)
    lo_t, hi_t = _t(lo.astype(np.int64)), _t(hi.astype(np.int64))
    pos_j = np.asarray(jb._positions(cfg_j, jnp.asarray(lo), jnp.asarray(hi), cfg_j.salt_perm))
    pos = baselines._positions(cfg, lo_t, hi_t, cfg.salt_perm).numpy()
    np.testing.assert_array_equal(pos, pos_j)
    np.testing.assert_array_equal(np.sort(pos, axis=1), np.broadcast_to(np.arange(m), (n, m)))
    sub = slice(0, 2000)
    r_j = np.asarray(jb._os_values(cfg_j, jnp.asarray(lo[sub]), jnp.asarray(hi[sub]), jnp.asarray(w[sub]),
                                   cfg_j.salt_h))
    r = baselines._os_values(cfg, lo_t[sub], hi_t[sub], _t(w[sub]), cfg.salt_h).numpy()
    np.testing.assert_allclose(r, r_j, rtol=1e-5, atol=0)
    assert (np.diff(r, axis=1) >= 0).all()


def test_estimate_merge_and_convert_match_jax():
    m = 64
    cfg_j, cfg = JCfg(m=m, b=8, seed=2), SketchConfig(m=m, b=8, seed=2)
    # The untouched-sketch guard: exactly 0.0 in both.
    assert float(baselines.estimate(baselines.init(cfg, device="cpu"))) == 0.0 == float(jb.estimate(jb.init(cfg_j)))
    states = []
    for seed in (1, 2):
        ids, w, _ = _batch(300, seed)
        sj = jb.fastgm_update(cfg_j, jb.init(cfg_j), jnp.asarray(ids), jnp.asarray(w))
        st = convert.from_jax_numpy(jb.FloatSketchState(*(np.asarray(x) for x in sj)), device="cpu")
        assert isinstance(st, FloatSketchState) and st.regs.dtype == torch.float32
        np.testing.assert_array_equal(convert.to_numpy(st).regs, np.asarray(sj.regs))
        states.append((sj, st))
    (aj, at), (bj, bt) = states
    mj, mt = jb.merge(aj, bj), baselines.merge(at, bt)
    np.testing.assert_array_equal(mt.regs.numpy(), np.asarray(mj.regs))
    np.testing.assert_allclose(float(baselines.estimate(mt)), float(jb.estimate(mj)), rtol=1e-5)
    # lm_estimate on a partly touched sketch follows Eq. 2.
    regs = mt.regs.clone()
    regs[:5] = estimators.F32_MAX
    np.testing.assert_allclose(float(estimators.lm_estimate(regs)),
                               float(jb.estimators.lm_estimate(jnp.asarray(regs.numpy()))), rtol=1e-5)


def test_lm_nonpositive_weight_is_a_noop_row():
    """K5's semantics on the port's LM path (the JAX package's lm_update
    differs here: ROADMAP queue 3)."""
    cfg = SketchConfig(m=16, b=8)
    st = baselines.lm_update(cfg, baselines.init(cfg, device="cpu"), torch.arange(4),
                             torch.tensor([-1.0, float("nan"), 0.0, -3.0]))
    assert (st.regs == estimators.F32_MAX).all()
    assert float(baselines.estimate(st)) == 0.0


def test_methods_registry_surface():
    assert tuple(METHODS) == METHOD_NAMES == tuple(JMETHODS)
    cfg = SketchConfig(m=64, b=8, seed=9)
    ids, w, _ = _batch(600, seed=4)
    for name, meth in METHODS.items():
        assert set(meth) == {"init", "update", "estimate", "merge", "register_bits"}
        assert meth["register_bits"] == JMETHODS[name]["register_bits"]
        st = meth["init"](cfg, device="cpu")
        halves = [meth["update"](cfg, meth["init"](cfg, device="cpu"), _t(ids[s]), _t(w[s]))
                  for s in (slice(0, 300), slice(300, 600))]
        whole = meth["update"](cfg, st, _t(ids), _t(w))
        merged = meth["merge"](cfg, *halves)
        est = float(meth["estimate"](cfg, merged))
        assert np.isfinite(est) and est > 0
        if name != "QSketch-Dyn":  # the max/min monoids merge exactly
            np.testing.assert_array_equal(merged.regs.numpy(), whole.regs.numpy())


def test_synthetic_streams_match_jax():
    for dist in synthetic.DISTRIBUTIONS:
        a, b = synthetic.stream(dist, 500, seed=3), jsynth.stream(dist, 500, seed=3)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
        a, b = synthetic.with_repeats(dist, 300, 2000, seed=1), jsynth.with_repeats(dist, 300, 2000, seed=1)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert synthetic.DISTRIBUTIONS == jsynth.DISTRIBUTIONS
    with pytest.raises(ValueError):
        synthetic.weights("pareto", 3, np.random.default_rng(0))


def test_quickstart_scenario_matches_jax():
    """``examples/quickstart.py``: every method over a gamma stream with Zipf
    repeats (40k occurrences of 8k distincts, m = 1024, batches of 8192),
    then the QSketch merge of two halves."""
    ids, weights, true_c = synthetic.with_repeats("gamma", 8_000, 40_000, seed=0)
    cfg_j, cfg = JCfg(m=1024, b=8, seed=42), SketchConfig(m=1024, b=8, seed=42)
    for name in METHOD_NAMES:
        sj, st = JMETHODS[name]["init"](cfg_j), METHODS[name]["init"](cfg, device="cpu")
        for i in range(0, len(ids), 8192):
            sl = slice(i, i + 8192)
            sj = JMETHODS[name]["update"](cfg_j, sj, jnp.asarray(ids[sl]), jnp.asarray(weights[sl]))
            st = METHODS[name]["update"](cfg, st, _ids_t(ids[sl]), _t(weights[sl]))
        est_j = float(JMETHODS[name]["estimate"](cfg_j, sj))
        est = float(METHODS[name]["estimate"](cfg, st))
        np.testing.assert_allclose(est, est_j, rtol=1e-5, err_msg=name)
        assert abs(est - true_c) / true_c < 0.2, name
    half = len(ids) // 2
    parts_j = [jq.update(cfg_j, jq.init(cfg_j), jnp.asarray(ids[s]), jnp.asarray(weights[s]))
               for s in (slice(0, half), slice(half, None))]
    parts = [qsketch.update(cfg, qsketch.init(cfg, device="cpu"), _ids_t(ids[s]), _t(weights[s]))
             for s in (slice(0, half), slice(half, None))]
    merged_j, merged = jq.merge(*parts_j), qsketch.merge(*parts)
    np.testing.assert_array_equal(merged.regs.numpy(), np.asarray(merged_j.regs))
    np.testing.assert_allclose(float(qsketch.estimate(cfg, merged)), float(jq.estimate(cfg_j, merged_j)),
                               rtol=1e-5)
