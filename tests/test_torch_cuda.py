"""K1–K4 on the card against their plain PyTorch versions, and the port's
main path on the card against its CPU path.

Marked ``cuda``: each test skips when ``torch.cuda.is_available()`` is
False. This file imports nothing of JAX, so it runs on a GPU host without
JAX: ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: ``tests/conftest.py`` imports
jax).

Tolerances: registers, histograms and the directory bit for bit (K1's y
uses the same logf/log2f as PyTorch's CUDA ops); q_R to an absolute 1e-6;
K4 and chats to rtol 1e-5, atol 1e-6 (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import SketchConfig, dyn_array, key_directory, qsketch, qsketch_dyn
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
    assert all(n > 0 for n in ops.launch_counts().values()), ops.launch_counts()
