"""K1–K4, K6 and K7 on the card against their plain PyTorch versions, and
the port's paths (the DynArray main path, the per-key SketchArray monitor,
the sliding-window monitor) on the card against their CPU paths, and the
``examples/windowed_alerts.py`` scenario on the card.

Marked ``cuda``: each test skips when ``torch.cuda.is_available()`` is
False. This file imports nothing of JAX, so it runs on a GPU host without
JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: ``tests/conftest.py`` imports
jax).

Tolerances: registers, histograms and the directory bit for bit (K1's and
K6's y use the same logf/log2f as PyTorch's CUDA ops); q_R to an absolute
1e-6; K4, chats and MLE reads to rtol 1e-5, atol 1e-6 (float32 sums in
another order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (
    SketchConfig, dyn_array, key_directory, qsketch, qsketch_dyn, sketch_array,
)
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
