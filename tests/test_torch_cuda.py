"""K1–K8 on the card against their plain PyTorch versions, and the port's
paths (the DynArray main path, the per-key SketchArray monitor, the
sliding-window monitor) on the card against their CPU paths, and the
scenarios of ``examples/windowed_alerts.py``, ``examples/quickstart.py``
(the five METHODS) and ``examples/virtual_tenants.py`` on the card.

Marked ``cuda``: each test skips when ``torch.cuda.is_available()`` is
False. This file imports nothing of JAX, so it runs on a GPU host without
JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: ``tests/conftest.py`` imports
jax).

Tolerances: registers, histograms, pools and the directory bit for bit
(K1's, K5's, K6's and K8's hashes and logs are PyTorch's CUDA ops'
arithmetic); q_R to an absolute 1e-6; K4, chats, ``w_tail`` and MLE reads
to rtol 1e-5, atol 1e-6 (float32 sums in another order); float
min-registers of the card against the CPU path to rtol 1e-6 (-ln u differs
by an ulp between the two devices' logs) and 1e-5 after FastGM's cumsum.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (
    METHODS, SketchConfig, baselines, dyn_array, estimation, estimators, key_directory, qsketch,
    qsketch_dyn, sketch_array,
)
from repro_torch.core import virtual_dyn_array as vda
from repro_torch.kernels import ops, ref
from repro_torch.sketchstream import monitor

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(n, seed, n_ids=None):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**63, n_ids or n, dtype=np.int64)
    ids = pool[rng.integers(0, len(pool), n)]
    w = (rng.gamma(1.0, 2.0, n) + 1e-4).astype(np.float32)
    w[::17] = 0.0
    mask = rng.random(n) > 0.05
    return torch.from_numpy(ids), torch.from_numpy(w), torch.from_numpy(mask)


@pytest.mark.parametrize("m,b", [(256, 8), (130, 4)])
def test_k1_kernel_matches_plain(dev, m, b):
    cfg = SketchConfig(m=m, b=b, seed=m)
    st = qsketch.init(cfg, device="cpu")
    for seed in range(3):
        ids, w, mask = _stream(5000, seed)
        lo, hi = ids & 0xFFFFFFFF, ids >> 32
        lw = torch.where(mask, torch.log2(w), torch.full_like(w, float("-inf")))
        want = ref.qsketch_update_ref(lo.to(dev), hi.to(dev), lw.to(dev), st.regs.to(dev),
                                      salt=cfg.salt_h, r_min=cfg.r_min, r_max=cfg.r_max)
        got = ops.qsketch_update_op(cfg, st.regs.to(dev), lo.to(dev), hi.to(dev), lw.to(dev))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        st = qsketch.QSketchState(regs=got.cpu())


@pytest.mark.parametrize("b", [4, 8])
def test_k2_k3_kernels_match_plain(dev, b):
    cfg = SketchConfig(m=256, b=b)
    rng = np.random.default_rng(b)
    w = torch.from_numpy((rng.gamma(1.0, 2.0, 3000) * 10.0 ** rng.integers(-4, 5, 3000)).astype(np.float32)).to(dev)
    hists = torch.from_numpy(rng.integers(0, 5, (50, cfg.num_bins)).astype(np.int32)).to(dev)
    hists[:, 0] = 0
    keys = torch.from_numpy(rng.integers(0, 50, 3000)).to(dev)
    keys[:2] = torch.tensor([-3, 70])  # clipped to [0, K) by kernel and plain version alike
    s = ops.scales(cfg, dev)
    torch.testing.assert_close(
        ops.qdyn_qr_op(cfg, hists[7].contiguous(), w),
        torch.clamp(ref.qdyn_qr_ref(w, hists[7], s, cfg.m), min=1e-12), rtol=0, atol=1e-6,
    )
    torch.testing.assert_close(
        ops.dyn_array_update_op(cfg, hists, keys, w),
        torch.clamp(ref.keyed_qr_ref(w, hists, keys, s, cfg.m), min=1e-12), rtol=0, atol=1e-6,
    )


@pytest.mark.parametrize("m,b", [(64, 8), (130, 4)])
def test_k4_kernel_matches_plain(dev, m, b):
    cfg = SketchConfig(m=m, b=b)
    rng = np.random.default_rng(m)
    regs = np.full((300, m), cfg.r_min, np.int64)
    for r in range(300):
        n = int(rng.integers(0, 4000)) if r % 3 else int(rng.integers(0, 40))
        j = rng.integers(0, m, n)
        y = np.clip(np.floor(np.log2(rng.gamma(1.0, 2.0, n) + 1e-4) - np.log2(rng.exponential(1.0, n))), cfg.r_min, cfg.r_max)
        np.maximum.at(regs[r], j, y.astype(np.int64))
    regs[5] = cfg.r_max  # degenerate high
    regs_t = torch.from_numpy(regs.astype(np.int8)).to(dev)
    chat, std, conv = ops.estimate_rows_op(cfg, regs_t, kind="full")
    chat_p, std_p, conv_p = ref.estimate_rows_ref(cfg, regs_t)
    torch.testing.assert_close(chat, chat_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(std, std_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(conv, conv_p)


def test_main_path_on_card_matches_cpu(dev):
    """The DynArray monitor, the scalar monitor and QSketch-Dyn on the card
    against the same path on the CPU: every kernel launches, state agrees."""
    cfg = SketchConfig(m=256, b=8, seed=3)
    mons = {d: monitor.DynArrayMonitor.for_capacity(cfg, 1024, device=d) for d in ("cpu", "cuda")}
    st = {d: mons[d].init() for d in mons}
    sc = {d: monitor.init(cfg, device=d) for d in mons}
    qd = {d: qsketch_dyn.init(cfg, device=d) for d in mons}
    rng = np.random.default_rng(2)
    tenants = rng.integers(0, 2**64, 300, dtype=np.uint64)
    ops.reset_launch_counts()
    for seed in range(4):
        ids, w, mask = _stream(4096, 10 + seed, n_ids=3000)
        t = tenants[rng.integers(0, 300, 4096)]
        for d in mons:
            keys = key_directory.split_uint64(t, device=d)
            st[d] = mons[d].update(st[d], keys, ids.to(d), w.to(d), mask=mask.to(d))
            sc[d] = monitor.update(cfg, sc[d], ids.to(d), w.to(d), mask=mask.to(d))
            qd[d] = qsketch_dyn.update_batch(cfg, qd[d], ids.to(d), w.to(d), mask=mask.to(d))
    a, b = st["cpu"], st["cuda"]
    for name in ("regs", "hists"):
        torch.testing.assert_close(getattr(b, name).cpu(), getattr(a, name), rtol=0, atol=0)
    for name in ("fingerprints", "last_touch", "n_routed", "n_collisions"):
        torch.testing.assert_close(getattr(b.directory, name).cpu(), getattr(a.directory, name), rtol=0, atol=0)
    torch.testing.assert_close(b.chats.cpu(), a.chats, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sc["cuda"].regs.cpu(), sc["cpu"].regs, rtol=0, atol=0)
    torch.testing.assert_close(qd["cuda"].regs.cpu(), qd["cpu"].regs, rtol=0, atol=0)
    torch.testing.assert_close(qd["cuda"].chat.cpu(), qd["cpu"].chat, rtol=1e-5, atol=1e-6)
    fused = {d: dyn_array.estimate_mle_rows(cfg, st[d].regs, solver="fused") for d in mons}
    torch.testing.assert_close(fused["cuda"].cpu(), fused["cpu"], rtol=1e-5, atol=1e-6)
    counts = ops.launch_counts()
    main_path = ("qsketch_update", "qdyn_qr", "dyn_array_update", "estimate")
    assert all(counts[name] > 0 for name in main_path), counts


@pytest.mark.parametrize("m,b,k", [(256, 8, 1000), (130, 4, 7)])
def test_k6_kernel_matches_plain(dev, m, b, k):
    """Keys out of range (clipped), masked rows, and hot keys: half of each
    batch lands on three rows."""
    cfg = SketchConfig(m=m, b=b, seed=m + k)
    regs = sketch_array.init(cfg, k, device="cuda").regs
    rng = np.random.default_rng(k)
    for seed in range(3):
        ids, w, mask = _stream(5000, 20 + seed)
        lo, hi = (ids & 0xFFFFFFFF).to(dev), (ids >> 32).to(dev)
        lw = torch.where(mask, torch.log2(w), torch.full_like(w, float("-inf"))).to(dev)
        keys = rng.integers(-2, k + 2, 5000)
        keys[::2] = rng.integers(0, 3, 2500)
        keys = torch.from_numpy(keys).to(dev)
        want = ref.sketch_array_update_ref(lo, hi, lw, keys, regs, salt=cfg.salt_h, r_min=cfg.r_min, r_max=cfg.r_max)
        got = ops.sketch_array_update_op(cfg, regs, keys, lo, hi, lw)
        assert got is regs
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (regs > cfg.r_min).any()


@pytest.mark.parametrize("e,k,m,b", [(8, 3000, 256, 8), (5, 37, 130, 4), (3, 64, 2052, 8)])
def test_k7_kernel_matches_plain(dev, e, k, m, b):
    """The word path (m % 4 == 0, m <= 2048) and the byte path (m = 130,
    m = 2052), at heads that wrap the window round the ring."""
    cfg = SketchConfig(m=m, b=b)
    rng = np.random.default_rng(e * k)
    regs = rng.integers(cfg.r_min, cfg.r_max + 1, (e, k, m)).astype(np.int8)
    regs[rng.random((e, k, m)) < 0.6] = cfg.r_min
    regs_t = torch.from_numpy(regs).to(dev)
    for head in (0, e // 2, e - 1):
        head_t = torch.tensor(head, dtype=torch.int32, device=dev)
        for w in range(1, e + 1):
            got = ops.window_union_op(cfg, regs_t, head_t, w)
            want = ref.window_union_ref(regs_t, head_t, w, r_min=cfg.r_min, nb=cfg.num_bins)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got.sum(1) == m).all()


def test_sketch_array_and_window_paths_on_card_match_cpu(dev):
    """The per-key SketchArray monitor (sparse ids through ``dcfg``) and the
    sliding-window monitor, on the card and on the CPU: K6, K3 and K7
    launch; integer state equal; chats and MLE reads to rtol 1e-5."""
    from repro_torch.sketchstream import anomaly

    cfg = SketchConfig(m=256, b=8, seed=5)
    devs = ("cpu", "cuda")
    wmon = {d: monitor.WindowMonitor.for_capacity(cfg, 512, 4, evict_after=3, device=d) for d in devs}
    ws = {d: wmon[d].init() for d in devs}
    arr = {d: monitor.init_array(cfg, 512, device=d) for d in devs}
    bank = {d: anomaly.init(512, device=d) for d in devs}
    bcfg = anomaly.AnomalyConfig(warmup=2, min_weight=10.0)
    rng = np.random.default_rng(4)
    tenants = rng.integers(0, 2**64, 200, dtype=np.uint64)
    ops.reset_launch_counts()
    for ep in range(6):
        for i in range(2):
            ids, w, mask = _stream(4096, 40 + 2 * ep + i, n_ids=3000)
            t = tenants[rng.integers(0, 200 - 25 * (ep // 2), 4096)]
            for d in devs:
                keys = key_directory.split_uint64(t, device=d)
                ws[d] = wmon[d].update(ws[d], keys, ids.to(d), w.to(d), mask=mask.to(d))
                arr[d] = monitor.update_array(cfg, arr[d], keys, ids.to(d), w.to(d), mask=mask.to(d),
                                              dcfg=wmon[d].dcfg)
        for d in devs:
            bank[d], _ = anomaly.step(bcfg, bank[d], wmon[d].estimate(ws[d]))
        a, b = ws["cpu"], ws["cuda"]
        for name in ("regs", "hists", "union_regs", "union_hists", "head", "filled", "epoch_id"):
            torch.testing.assert_close(getattr(b.window, name).cpu(), getattr(a.window, name), rtol=0, atol=0)
        torch.testing.assert_close(b.window.chats.cpu(), a.window.chats, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(b.window.union_chats.cpu(), a.window.union_chats, rtol=1e-5, atol=1e-6)
        for name in ("fingerprints", "last_touch", "n_routed", "n_collisions"):
            torch.testing.assert_close(getattr(b.directory, name).cpu(), getattr(a.directory, name), rtol=0, atol=0)
        for wdw in (1, 2, 3):
            torch.testing.assert_close(wmon["cuda"].estimate(b, w=wdw).cpu(), wmon["cpu"].estimate(a, w=wdw),
                                       rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(bank["cuda"].score.cpu(), bank["cpu"].score, rtol=1e-5, atol=1e-5)
        for d in devs:
            ws[d] = wmon[d].rotate(ws[d])
    torch.testing.assert_close(arr["cuda"].regs.cpu(), arr["cpu"].regs, rtol=0, atol=0)
    torch.testing.assert_close(monitor.estimate_array(cfg, arr["cuda"]).cpu(), monitor.estimate_array(cfg, arr["cpu"]),
                               rtol=1e-5, atol=1e-6)
    counts = ops.launch_counts()
    assert counts["sketch_array_update"] > 0 and counts["window_union"] > 0 and counts["dyn_array_update"] > 0, counts


def test_windowed_alerts_scenario_on_card(dev):
    """``examples/windowed_alerts.py`` at its own sizes on the card (the
    CPU twin is in ``tests/test_torch_window.py``): the flood tenant
    surfaces in the top-5 alerts from its epoch on, and no baseline tenant
    ever alerts."""
    from repro_torch.data import synthetic
    from repro_torch.sketchstream import anomaly

    cfg = SketchConfig(m=64, b=8, seed=11)
    capacity, n_tenants, n_flows, n_epochs, window = 2**14, 48, 20000, 16, 6
    packets, spike_epoch, spike_packets, spike_tenant = 30000, 13, 4000, 11
    mon = monitor.WindowMonitor.for_capacity(cfg, capacity, window, evict_after=window, device=dev)
    bcfg = anomaly.AnomalyConfig(warmup=window + 2, min_weight=2000.0, cusum_h=8.0)
    rng = np.random.default_rng(7)
    tenant_ids = rng.integers(0, 2**64, n_tenants, dtype=np.uint64)
    keys, flows, sizes, _ = synthetic.netflow_keyed(n_tenants, n_flows, n_epochs * packets, seed=3)
    st, bank = mon.init(), anomaly.init(capacity, device=dev)
    spike_slot = int(key_directory.route_slots(mon.dcfg, key_directory.split_uint64(tenant_ids, dev))[spike_tenant])
    spiked = false_positive = False
    ops.reset_launch_counts()
    for ep in range(n_epochs):
        sl = slice(ep * packets, (ep + 1) * packets)
        ep_keys, ep_flows, ep_sizes = keys[sl], flows[sl], sizes[sl]
        if ep == spike_epoch:
            ep_keys = np.concatenate([ep_keys, np.full(spike_packets, spike_tenant, np.int32)])
            ep_flows = np.concatenate([ep_flows, rng.integers(0, 2**32, spike_packets, dtype=np.uint32)])
            ep_sizes = np.concatenate([
                ep_sizes, np.clip(rng.lognormal(6.0, 1.0, spike_packets), 40, 65535).astype(np.float32)])
        st = mon.update(st, key_directory.split_uint64(tenant_ids[ep_keys], dev),
                        torch.from_numpy(ep_flows.astype(np.int64)).to(dev), torch.from_numpy(ep_sizes).to(dev))
        bank, scores = anomaly.step(bcfg, bank, mon.estimate(st))
        alert_slots = [s for s, _ in anomaly.top_alerts(bcfg, scores, n=5)]
        spiked |= ep >= spike_epoch and spike_slot in alert_slots
        false_positive |= any(s != spike_slot for s in alert_slots)
        st = mon.rotate(st)
    assert spiked, "the flood tenant was never among the top-5 alerts"
    assert not false_positive, "a baseline tenant alerted"
    assert int(st.n_seen) == n_epochs * packets + spike_packets
    assert ops.launch_counts()["dyn_array_update"] > 0


@pytest.mark.parametrize("m", [256, 1024, 130])
def test_k5_kernel_matches_plain(dev, m):
    """Rows with w <= 0 or NaN (masked rows arrive as w = -1) are no-ops."""
    cfg = SketchConfig(m=m, b=8, seed=m)
    regs = baselines.init(cfg, device="cuda").regs
    for seed in range(3):
        ids, w, mask = _stream(5000, 30 + seed)
        w[1::23] = float("nan")
        w = torch.where(mask, w, torch.full_like(w, -1.0))
        lo, hi = (ids & 0xFFFFFFFF).to(dev), (ids >> 32).to(dev)
        want = ref.float_sketch_update_ref(lo, hi, w.to(dev), regs, salt=cfg.salt_h)
        got = ops.float_sketch_update_op(cfg, regs, lo, hi, w.to(dev))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        regs = got
    assert (regs < estimators.F32_MAX).all()


@pytest.mark.parametrize("m_v", [256, 96])
def test_k8_kernel_matches_plain(dev, m_v):
    cfg = SketchConfig(m=256, b=8, seed=3)
    rng = np.random.default_rng(m_v)
    n = 100_000
    lo, hi, t_lo, t_hi = (torch.from_numpy(rng.integers(0, 2**32, n)).to(dev) for _ in range(4))
    w = rng.gamma(1.0, 2.0, n).astype(np.float32) * np.float32(10.0) ** rng.integers(-30, 30, n)
    w[::13], w[5::17], w[7::19], w[9::23] = 0.0, -1.0, np.nan, np.inf
    with np.errstate(divide="ignore", invalid="ignore"):
        log2w = torch.from_numpy(np.log2(w).astype(np.float32)).to(dev)
    args = dict(salt_g=cfg.salt_g, salt_h=cfg.salt_h, salt_pool=12345, m=m_v, pool_size=2**26,
                r_min=cfg.r_min, r_max=cfg.r_max)
    want = ref.virtual_pool_route_ref(lo, hi, t_lo, t_hi, log2w, **args)
    got = ops.virtual_pool_route_op(cfg, m_v, 12345, 2**26, lo, hi, t_lo, t_hi, log2w)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(got[1].min()) == cfg.r_min and int(got[1].max()) == cfg.r_max


def test_quickstart_scenario_on_card_matches_cpu(dev):
    """``examples/quickstart.py``'s five METHODS on the card and on the CPU:
    K1, K2 and K5 launch; QSketch and QSketch-Dyn registers equal, float
    min-registers and estimates close."""
    from repro_torch.data import synthetic

    ids, weights, true_c = synthetic.with_repeats("gamma", 8_000, 40_000, seed=0)
    cfg = SketchConfig(m=1024, b=8, seed=42)
    ops.reset_launch_counts()
    for name, meth in METHODS.items():
        out = {}
        for d in ("cpu", "cuda"):
            st = meth["init"](cfg, device=d)
            for i in range(0, len(ids), 8192):
                st = meth["update"](cfg, st, torch.from_numpy(ids[i:i + 8192].astype(np.int64)).to(d),
                                    torch.from_numpy(weights[i:i + 8192]).to(d))
            out[d] = (st, float(meth["estimate"](cfg, st)))
        (a, ea), (b, eb) = out["cpu"], out["cuda"]
        if name in ("QSketch", "QSketch-Dyn"):
            torch.testing.assert_close(b.regs.cpu(), a.regs, rtol=0, atol=0)
        else:
            torch.testing.assert_close(b.regs.cpu(), a.regs, rtol=1e-6 if name == "LM" else 1e-5, atol=0)
        assert abs(eb - ea) <= 1e-5 * abs(ea), (name, ea, eb)
        assert abs(eb - true_c) / true_c < 0.2, name
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("qsketch_update", "qdyn_qr", "float_sketch_update")), counts


def _grid_flips(tcfg, rows, chat_d, chat_c):
    """Rows whose virtual row solve differs between the card (``chat_d``)
    and the CPU (``chat_c``) beyond rtol 1e-5, and whether each is a near
    tie of the grid argmax: the float64 log-likelihood margin between the
    two final grid points is within twice the float32 rounding of the
    likelihood there on the two devices."""
    off = torch.nonzero((chat_d - chat_c).abs() > 1e-5 * chat_c.abs() + 1e-6)[:, 0]
    if not off.numel():
        return off, torch.ones((0,), dtype=torch.bool)
    hd = estimators.histograms(tcfg, rows[off.to(rows.device)])
    h64 = hd.cpu()
    lam64 = torch.log(tcfg.m / torch.clamp(h64[:, 0].double(), min=0.5))
    grid64 = torch.stack([torch.round(32 * torch.log2(c[off].double() / (tcfg.m * lam64))) / 32
                          for c in (chat_d, chat_c)], 1)
    ll64 = estimation._virtual_loglik(tcfg, h64, lam64, grid64)
    err = torch.zeros(off.numel(), dtype=torch.float64)
    for h in (hd, h64):
        t0 = h[:, 0].to(torch.float32)
        lam = torch.log(torch.full_like(t0, float(tcfg.m)) / torch.clamp(t0, min=0.5))
        ll = estimation._virtual_loglik(tcfg, h, lam, grid64.to(h.device, torch.float32))
        err += (ll.cpu().double() - ll64).abs().max(1).values
    return off, (ll64[:, 0] - ll64[:, 1]).abs() <= 2 * err


def test_virtual_tenants_scenario_on_card_matches_cpu(dev):
    """``examples/virtual_tenants.py`` on the card and on the CPU: K8 and K3
    launch; pool, pool histogram, counters and hot rows equal (w_tail and
    chats to rtol 1e-5); the reads within the example's accuracy; the
    promotion of rank 32 reads its 4096 fresh events."""
    cfg = SketchConfig(m=128, b=8, seed=3)
    n_tenants, n_pin, pool_size = 2048, 32, 2**16
    rng = np.random.default_rng(7)
    tenant_ids = rng.integers(0, 2**63, n_tenants, dtype=np.uint64)
    sizes = np.maximum(6000.0 / np.arange(1, n_tenants + 1) ** 1.05, 8).astype(int)
    tidx = np.repeat(np.arange(n_tenants), sizes)
    rng.shuffle(tidx)
    n = tidx.shape[0]
    ids = rng.permutation(np.arange(n, dtype=np.int64))
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    truth = np.zeros(n_tenants)
    np.add.at(truth, tidx, w)
    pinned = tuple(int(t) for t in tenant_ids[:n_pin])
    mons, sts, ests = {}, {}, {}
    ops.reset_launch_counts()
    for d in ("cpu", "cuda"):
        mon = monitor.VirtualDynMonitor.for_pool(cfg, pool_size, pinned=pinned, device=d)
        st = mon.init()
        for lo in range(0, n, 8192):
            sl = slice(lo, min(lo + 8192, n))
            st = mon.update(st, key_directory.split_uint64(tenant_ids[tidx[sl]], d),
                            torch.from_numpy(ids[sl]).to(d), torch.from_numpy(w[sl]).to(d))
        mons[d], sts[d] = mon, st
        ests[d] = mon.estimate(st, key_directory.split_uint64(tenant_ids, d)).cpu().numpy()
    counts = ops.launch_counts()
    assert counts["virtual_pool_route"] > 0 and counts["dyn_array_update"] > 0, counts
    a, b = sts["cpu"].array, sts["cuda"].array
    for name in ("pool", "pool_hist", "n_tail"):
        torch.testing.assert_close(getattr(b, name).cpu(), getattr(a, name), rtol=0, atol=0)
    for name in ("regs", "hists"):
        torch.testing.assert_close(getattr(b.hot, name).cpu(), getattr(a.hot, name), rtol=0, atol=0)
    torch.testing.assert_close(b.hot.chats.cpu(), a.hot.chats, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(b.w_tail.cpu(), a.w_tail, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ests["cuda"][:n_pin], ests["cpu"][:n_pin], rtol=1e-5, atol=1e-6)
    # The tail read's stages on the card against the CPU: the row solves on
    # the same gathered registers, then the pool calibration. A row whose
    # grid argmax flips between the two devices must be a near tie.
    vcfg = mons["cuda"].vcfg
    rows = vda.virtual_rows(cfg, vcfg, b, *key_directory.split_uint64(tenant_ids[n_pin:], dev))
    tcfg = vda.tail_config(cfg, vcfg)
    chat_d = estimation.estimate_rows_virtual(tcfg, rows).cpu()
    chat_c = estimation.estimate_rows_virtual(tcfg, rows.cpu())
    off, ties = _grid_flips(tcfg, rows, chat_d, chat_c)
    assert bool(ties.all()), [(int(r), float(chat_d[r]), float(chat_c[r])) for r in off]
    keep = torch.ones_like(chat_c, dtype=torch.bool)
    keep[off] = False
    torch.testing.assert_close(chat_d[keep], chat_c[keep], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(vda.pool_calibration(cfg, vcfg, b)),
                               float(vda.pool_calibration(cfg, mons["cpu"].vcfg, a)), rtol=1e-5)
    floor = float(vda.noise_floor(cfg, vcfg, b))
    rel = np.abs(ests["cuda"] - truth) / truth
    tail_above = (truth >= 2 * floor) & (np.arange(n_tenants) >= n_pin)
    assert rel[:n_pin].mean() < 0.1 and tail_above.sum() > 0 and rel[tail_above].mean() < 0.5
    riser = int(tenant_ids[n_pin])
    mon, st = mons["cuda"].promote(sts["cuda"], riser)
    w2 = rng.uniform(0.5, 1.5, 4096).astype(np.float32)
    st = mon.update(st, key_directory.split_uint64(np.full(4096, riser, np.uint64), dev),
                    torch.arange(n, n + 4096, device=dev), torch.from_numpy(w2).to(dev))
    resumed = float(mon.estimate(st, key_directory.split_uint64([riser], dev))[0])
    assert abs(resumed - w2.sum()) / w2.sum() < 0.2
