"""K1–K4: each plain PyTorch version of the port against the JAX package's
``*_padded`` kernel entry run with ``interpret=True`` (never the JAX
``ops`` fronts — under this jax they reach ``jax.core.trace_state_clean``,
which is gone), plus the fronts' operand checks and the device rule.

Tolerances: registers bit for bit; q_R to an absolute 1e-6 (the sum runs
in another order); K4 on rows where every register is touched to rtol 1e-5
against the JAX fused entry and within ``LUT_RTOL`` of the float64 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SketchConfig as JCfg
from repro.core import estimators as jestimators
from repro.kernels import dyn_array_update as jk3
from repro.kernels import estimate as jk4
from repro.kernels import qdyn_qr as jk2
from repro.kernels import qsketch_update as jk1
from repro_torch.core import SketchConfig, estimation, estimators, qsketch
from repro_torch.kernels import ops, ref


def _pad_to(n, mult):
    return -(-n // mult) * mult


@pytest.mark.parametrize("batch,m,b", [(64, 128, 8), (100, 384, 8), (513, 130, 4), (8, 64, 8)])
def test_k1_plain_matches_jax_kernel(batch, m, b):
    cfg_j, cfg = JCfg(m=m, b=b, seed=batch + m), SketchConfig(m=m, b=b, seed=batch + m)
    rng = np.random.default_rng(batch * 7 + m)
    lo = rng.integers(0, 2**32, batch, dtype=np.uint32)
    hi = rng.integers(0, 2**32, batch, dtype=np.uint32)
    w = (rng.gamma(1.0, 2.0, batch) + 1e-5).astype(np.float32)
    w[::7] = 0.0  # zero weights: log2 w = -inf, a no-op row
    with np.errstate(divide="ignore"):
        log2w = np.log2(w).astype(np.float32)
    regs = rng.integers(cfg.r_min, 3, m).astype(np.int8)

    bb, bm = 64, 128
    bp, mp = _pad_to(batch, bb), _pad_to(m, bm)
    pad = lambda a, n, fill: np.concatenate([a, np.full(n - len(a), fill, a.dtype)])[:, None]
    regs_p = np.full((1, mp), cfg.r_min, np.int32)
    regs_p[0, :m] = regs
    out_j = jk1.qsketch_update_padded(
        jnp.asarray(pad(lo, bp, 0)), jnp.asarray(pad(hi, bp, 0)),
        jnp.asarray(pad(log2w, bp, -np.inf)), jnp.asarray(regs_p),
        block_b=bb, block_m=bm, salt=cfg.salt_h, r_min=cfg.r_min, r_max=cfg.r_max,
        interpret=True,
    )
    out_t = ops.qsketch_update_op(
        cfg, torch.from_numpy(regs), torch.from_numpy(lo.astype(np.int64)),
        torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(log2w),
    )
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j)[0, :m].astype(np.int8))


def _hist(cfg, rng, k=None):
    shape = (cfg.num_bins,) if k is None else (k, cfg.num_bins)
    h = rng.integers(0, 4, shape).astype(np.int32)
    h[..., 0] = 0
    return h


@pytest.mark.parametrize("b", [4, 8])
def test_k2_plain_matches_jax_kernel(b):
    cfg = SketchConfig(m=256, b=b, seed=b)
    rng = np.random.default_rng(b)
    w = (rng.gamma(1.0, 2.0, 700) * 10.0 ** rng.integers(-4, 5, 700)).astype(np.float32)
    hist = _hist(cfg, rng)
    nbp = _pad_to(cfg.num_bins, 128)
    s = np.zeros((1, nbp), np.float32)
    s[0, : cfg.num_bins] = estimators._bin_scales(cfg)
    hp = np.zeros((1, nbp), np.float32)
    hp[0, : cfg.num_bins] = hist
    wp = np.ones((1024, 1), np.float32)
    wp[:700, 0] = w
    q_j = np.asarray(jk2.qdyn_qr_padded(
        jnp.asarray(wp), jnp.asarray(hp), jnp.asarray(s), m=cfg.m, block_b=512, interpret=True
    ))[:700, 0]
    q_t = ref.qdyn_qr_ref(torch.from_numpy(w), torch.from_numpy(hist), ops.scales(cfg, "cpu"), cfg.m)
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=1e-6)
    # The front floors q_R at 1e-12, as the JAX front does.
    q_f = ops.qdyn_qr_op(cfg, torch.from_numpy(hist), torch.from_numpy(w))
    np.testing.assert_array_equal(q_f.numpy(), np.maximum(q_t.numpy(), np.float32(1e-12)))


def test_k3_plain_matches_jax_kernel():
    cfg = SketchConfig(m=256, b=8, seed=9)
    rng = np.random.default_rng(9)
    k, batch = 33, 600
    hists = _hist(cfg, rng, k)
    keys = rng.integers(0, k, batch)
    w = (rng.gamma(1.0, 2.0, batch) + 1e-5).astype(np.float32)
    rows = np.zeros((1024, 256), np.float32)
    rows[:batch] = hists[keys]
    wp = np.ones((1024, 1), np.float32)
    wp[:batch, 0] = w
    s = estimators._bin_scales(cfg)[None, :]
    q_j = np.asarray(jk3.dyn_array_qr_padded(
        jnp.asarray(wp), jnp.asarray(rows), jnp.asarray(s), m=cfg.m, block_b=512, interpret=True
    ))[:batch, 0]
    q_t = ops.dyn_array_update_op(
        cfg, torch.from_numpy(hists), torch.from_numpy(keys), torch.from_numpy(w)
    )
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=1e-6)


def dense_rows(k, m, n, seed, b=8):
    """k routed register rows of m registers, each fed n elements — dense
    enough that every register is touched."""
    cfg = SketchConfig(m=m, b=b)
    rng = np.random.default_rng(seed)
    regs = np.full((k, m), cfg.r_min, np.int64)
    for r in range(k):
        j = rng.integers(0, m, n)
        e = rng.exponential(1.0, n)
        w = rng.gamma(1.0, 2.0, n) + 1e-4
        y = np.clip(np.floor(np.log2(w) - np.log2(e)), cfg.r_min, cfg.r_max)
        np.maximum.at(regs[r], j, y.astype(np.int64))
    return regs.astype(np.int8)


def _jax_fused(cfg, regs):
    k, m = regs.shape
    kp = _pad_to(k, 8)
    pad = np.full((kp, _pad_to(m, 128)), cfg.r_min, np.int8)
    pad[:k, :m] = regs
    chat, std, conv = jk4.estimate_rows_padded(
        jnp.asarray(pad), m=m, nb_padded=_pad_to(cfg.num_bins, 128), r_min=cfg.r_min,
        top_bin=cfg.top_bin, block_k=8, interpret=True,
    )
    return np.asarray(chat)[:k, 0], np.asarray(std)[:k, 0], np.asarray(conv)[:k, 0] > 0


@pytest.mark.parametrize("n", [2048, 8192])
def test_k4_plain_matches_jax_kernel_on_touched_rows(n):
    cfg, cfg_j = SketchConfig(m=64), JCfg(m=64)
    regs = dense_rows(16, 64, n, seed=n)
    assert (regs > cfg.r_min).all(), "every register must be touched"
    chat_j, std_j, conv_j = _jax_fused(cfg, regs)
    chat, std, conv = ref.estimate_rows_ref(cfg, torch.from_numpy(regs))
    np.testing.assert_allclose(chat.numpy(), chat_j, rtol=1e-5)
    np.testing.assert_allclose(std.numpy(), std_j, rtol=1e-5)
    np.testing.assert_array_equal(conv.numpy(), conv_j)
    oracle = np.array([jestimators.mle_numpy(cfg_j, r) for r in regs])
    np.testing.assert_allclose(chat.numpy(), oracle, rtol=estimation.LUT_RTOL)
    # The fused solver through the estimation layer: routed = ×m.
    routed = estimation.estimate_rows(cfg, torch.from_numpy(regs), solver="fused")
    np.testing.assert_allclose(routed.numpy(), chat.numpy() * cfg.m, rtol=1e-6)


@pytest.mark.parametrize("kind", ["full", "routed"])
def test_estimate_with_ci_newton_matches_jax(kind):
    """(Ĉ, stddev, converged) of the newton solver from rows and from
    histograms, on touched rows, a sparse row and an all-r_min row."""
    from repro.core import estimation as jestimation

    cfg, cfg_j = SketchConfig(m=64), JCfg(m=64)
    regs = dense_rows(6, 64, 4096, seed=3)
    regs[4] = dense_rows(1, 64, 16, seed=4)[0]
    regs[5] = cfg.r_min
    want = jestimation.estimate_rows_with_ci(cfg_j, jnp.asarray(regs), kind=kind)
    hists = estimators.histograms(cfg, torch.from_numpy(regs))
    for got in (
        estimation.estimate_rows_with_ci(cfg, torch.from_numpy(regs), kind=kind),
        estimation.estimate_hists_with_ci(cfg, hists, kind=kind),
    ):
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=estimation.ATOL_FLOOR)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (np.asarray(want[0])[:4] > 100).all()


def test_k4_sparse_row_collapses_like_the_reference():
    """A row that still has untouched registers drives the histogram MLE to
    ~0 (DESIGN.md §10.4): the port's plain version collapses as the JAX
    fused entry does; an all-r_min row is exactly 0 and not converged."""
    cfg = SketchConfig(m=64)
    regs = dense_rows(4, 64, 16, seed=1)
    regs[3] = cfg.r_min
    chat_j, _, conv_j = _jax_fused(cfg, regs)
    chat, _, conv = ref.estimate_rows_ref(cfg, torch.from_numpy(regs))
    assert (np.abs(chat_j[:3]) <= 1e-20).all()
    assert (np.abs(chat.numpy()[:3]) * cfg.m <= 1e-20).all()
    assert chat[3] == 0.0 and not conv[3] and not conv_j[3]


def test_fronts_reject_bad_operands():
    cfg = SketchConfig(m=64)
    regs = torch.full((64,), cfg.r_min, dtype=torch.int8)
    lo = torch.zeros(8, dtype=torch.int64)
    lw = torch.zeros(8, dtype=torch.float32)
    with pytest.raises(TypeError):
        ops.qsketch_update_op(cfg, regs.to(torch.int32), lo, lo, lw)
    with pytest.raises(ValueError):
        ops.qsketch_update_op(cfg, regs[:32], lo, lo, lw)
    with pytest.raises(ValueError):
        ops.qsketch_update_op(cfg, regs, lo, lo, lw[:4])
    with pytest.raises(ValueError):
        ops.qsketch_update_op(cfg, torch.stack([regs, regs], 1)[:, 0], lo, lo, lw)
    with pytest.raises(ValueError):
        ops.qsketch_update_op(cfg, regs.to("meta"), lo, lo, lw)
    hists = torch.zeros((4, cfg.num_bins), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.dyn_array_update_op(cfg, hists.t().contiguous().t(), lo, lw)
    with pytest.raises(TypeError):
        ops.dyn_array_update_op(cfg, hists, lo.to(torch.int32), lw)
    with pytest.raises(ValueError):
        ops.estimate_rows_op(cfg, torch.zeros((3, 65), dtype=torch.int8))
    with pytest.raises(ValueError):
        ops.estimate_rows_op(cfg, torch.zeros((3, 64), dtype=torch.int8), kind="bogus")


def test_entry_points_refuse_cuda_without_a_gpu(monkeypatch):
    """Without a GPU an entry point raises unless given device="cpu"."""
    from repro_torch.core import (
        VirtualConfig, baselines, dyn_array, qsketch_dyn, sketch_array, virtual_dyn_array, window_array,
    )
    from repro_torch.sketchstream import anomaly, monitor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SketchConfig(m=64)
    for make in (
        lambda: baselines.init(cfg),
        lambda: virtual_dyn_array.init(cfg, VirtualConfig(pool_size=1024)),
        lambda: monitor.VirtualDynMonitor.for_pool(cfg, 1024),
        lambda: sketch_array.init(cfg, 4),
        lambda: window_array.init(cfg, 4, 2),
        lambda: monitor.init_array(cfg, 4),
        lambda: monitor.WindowMonitor.for_capacity(cfg, 16, 2),
        lambda: anomaly.init(4),
        lambda: qsketch.init(cfg),
        lambda: qsketch_dyn.init(cfg),
        lambda: dyn_array.init(cfg, 4),
        lambda: monitor.init(cfg),
        lambda: monitor.DynArrayMonitor.for_capacity(cfg, 16),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert qsketch.init(cfg, device="cpu").regs.device.type == "cpu"


def test_launch_counts_stay_zero_on_cpu():
    """CPU tensors take the plain versions: no kernel is launched."""
    from repro_torch.core import VirtualConfig, baselines, sketch_array, virtual_dyn_array, window_array

    ops.reset_launch_counts()
    cfg = SketchConfig(m=64)
    st = qsketch.init(cfg, device="cpu")
    qsketch.update(cfg, st, torch.arange(10), torch.ones(10))
    estimation.estimate_rows(cfg, st.regs[None, :], solver="fused")
    sa = sketch_array.init(cfg, 3, device="cpu")
    sketch_array.update(cfg, sa, torch.tensor([0, 2]), torch.arange(2), torch.ones(2))
    ring = window_array.init(cfg, 3, 2, device="cpu")
    window_array.estimate_window(cfg, ring, 1)
    baselines.lm_update(cfg, baselines.init(cfg, device="cpu"), torch.arange(10), torch.ones(10))
    vcfg = VirtualConfig(pool_size=1024, pinned=(3,))
    virtual_dyn_array.update_tenants(cfg, vcfg, virtual_dyn_array.init(cfg, vcfg, device="cpu"),
                                     torch.tensor([3, 5]), torch.arange(2), torch.ones(2))
    assert set(ops.launch_counts()) == {
        "qsketch_update", "qdyn_qr", "dyn_array_update", "estimate", "float_sketch_update",
        "sketch_array_update", "window_union", "virtual_pool_route",
    }
    assert all(v == 0 for v in ops.launch_counts().values())
